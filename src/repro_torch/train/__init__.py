"""The LM track's training: losses, AdamW, the train, serve and prefill
steps, and the fault-tolerant trainer."""
