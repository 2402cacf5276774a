"""Printed bespoke MLP in PyTorch."""
