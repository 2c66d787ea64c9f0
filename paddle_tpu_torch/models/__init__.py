"""Model builders of the port: the transformer (scoring and training),
the IMDB sentiment classifiers, the attention translator (training), the
recognize_digits nets and the ResNets of image_classification."""
