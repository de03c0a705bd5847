"""Host utilities: phase timing and checkpointing."""
