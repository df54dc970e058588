"""The WGAN-GP generator."""
