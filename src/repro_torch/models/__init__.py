"""The paper's 2-layer MNIST MLP."""
