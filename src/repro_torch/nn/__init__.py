"""Neural-net substrate in PyTorch: the printed MLP (`mlp`) and the LM
track's layers, attention and transformer."""
