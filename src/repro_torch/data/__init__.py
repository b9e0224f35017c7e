"""Synthetic MNIST and the non-IID federated partition."""
