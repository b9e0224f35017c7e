"""The FEEL round (Algorithm 1): local training, evaluation, FedAvg."""
