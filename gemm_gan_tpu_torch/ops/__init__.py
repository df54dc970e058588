"""FiLM, MLP and attention building blocks."""
