"""Roofline of a step on the card: the H100's constants (`hw`), a counter
of one step's FLOPs, bytes and live memory, the affine depth fit and the
three-term roofline (`analysis`), the counterpart of `repro.roofline`."""
