"""Seeded synthetic data: UCI datasets (`uci`) and the LM token stream
(`tokens`)."""
