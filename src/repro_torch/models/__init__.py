# The model path: layers (K4 and K5 inside), the language model, batches.
