"""Model builders of the port (this slice: the transformer scoring graph)."""
