"""Training: the train step, the trainer loop and checkpoints."""
