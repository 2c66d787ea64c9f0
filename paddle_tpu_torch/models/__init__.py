"""Model builders of the port: the transformer (scoring and training),
the IMDB sentiment classifiers and the attention translator (training)."""
