"""Step builders shared by serving and training."""
