"""Parameter schemas, layers, attention and the decoder LM."""
