"""Device path of the port: int64 residue tensors, torch NTT, the BEHZ tail
kernels and the batched engine."""
