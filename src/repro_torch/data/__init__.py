"""Synthetic MNIST, synthetic token streams and the non-IID federated
partition. The public names are the JAX package's
``repro.data.__all__``."""
from repro_torch.data.partition import (ClientData, GROUP_SIZE,
                                        label_histogram, pad_clients,
                                        partition)
from repro_torch.data.synthetic_mnist import Dataset, N_CLASSES, generate
from repro_torch.data.tokens import (TokenDataset, batches, make_stream,
                                     make_windows, zipf_probs)

__all__ = ["ClientData", "GROUP_SIZE", "label_histogram", "pad_clients",
           "partition", "Dataset", "N_CLASSES", "generate", "TokenDataset",
           "batches", "make_stream", "make_windows", "zipf_probs"]
