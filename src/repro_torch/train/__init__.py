"""Serve and prefill steps of the LM track (the train step is a later
slice of the port)."""
