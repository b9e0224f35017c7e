"""Synthetic MNIST, synthetic token streams and the non-IID federated
partition."""
