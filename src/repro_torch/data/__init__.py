"""Seeded synthetic UCI datasets."""
