"""Model builders of the port: the transformer (scoring and training) and
the IMDB sentiment classifiers."""
