"""The WGAN-GP training step: losses, optimizer, state and engine."""
