"""Printed-MLP classifier configurations (copied from `repro.configs`)."""
