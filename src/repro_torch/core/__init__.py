"""Hardware-aware neural minimization: quantization, pruning, clustering,
priced by the printed-area model and searched with NSGA-II."""
