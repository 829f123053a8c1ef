"""FedS3A on PyTorch: the sequential round engine and what it runs."""
