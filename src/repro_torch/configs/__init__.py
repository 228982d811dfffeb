"""Model configurations of the port (the paper's CNN, ``paper_cnn``)."""
