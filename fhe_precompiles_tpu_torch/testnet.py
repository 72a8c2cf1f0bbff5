"""Testnet parameter/runtime singletons.

The port's own copy of ``fhe_precompiles_tpu/testnet.py``.  Parity target:
the reference's ``src/testnet.rs`` -- module ``one`` exposes PARAMS /
RUNTIME (here: the BfvContext) / FHE (lazy app singleton) / generate_keys.
New testnets are added as further modules in the registry pattern
(testnet.rs:1-2 implies `one` -> future `two`).
"""
from __future__ import annotations

import functools

from .app import FheApp
from .bfv.golden import BfvContext
from .params import TESTNET_ONE


class _TestnetOne:
    """Lazy singletons for the first testnet (testnet.rs:8-25)."""

    PARAMS = TESTNET_ONE

    @functools.cached_property
    def RUNTIME(self) -> BfvContext:  # noqa: N802 - parity naming
        return BfvContext(self.PARAMS)

    @functools.cached_property
    def FHE(self) -> FheApp:  # noqa: N802 - parity naming
        # the port's singleton is the torch engine on the card, built on
        # first use: importing the package touches no device.  A caller that
        # wants the golden model or the CPU builds an FheApp itself.
        return FheApp(self.PARAMS, engine="torch")

    def generate_keys(self):
        """Fresh user keypair under testnet-one params (testnet.rs:20-22).

        Through RUNTIME: TorchEngine has no keygen, so the keys are the
        golden model's either way."""
        return self.RUNTIME.generate_keys()


one = _TestnetOne()
