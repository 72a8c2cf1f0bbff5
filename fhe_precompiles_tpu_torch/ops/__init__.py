"""Device path of the port: int64 residue tensors, the NTT and BEHZ tail
kernels with their plain versions, and the batched engine."""
