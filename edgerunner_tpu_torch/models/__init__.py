"""Models of the PyTorch port: layers, point encoder, ShapeOPT decoder, LMM."""
