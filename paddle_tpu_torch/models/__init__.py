"""Model builders of the port: the transformer (scoring and training),
the IMDB sentiment classifiers, the attention translator (training), the
recognize_digits nets, the ResNets of image_classification, the dense zoo
models (word2vec, ctr, recommender_system, language_model) and the zoo
registry over them."""
