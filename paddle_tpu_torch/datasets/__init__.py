"""Dataset metadata the port's models size themselves from (the port's own
copies of the JAX package's datasets: no import of it)."""
