"""The benchmark's plain reference: a frozen numpy copy of the BFV golden
model (key generation, encryption, decryption, add / sub, BEHZ multiply and
relinearization), and the control that ``bench_port/check.py`` must fail.

Nothing here imports the program under test, ``jax`` or the JAX package."""
