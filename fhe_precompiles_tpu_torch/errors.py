"""Error model of the precompiles.

The port's own copy of ``fhe_precompiles_tpu/errors.py``: the 7-code
``FheError`` enum of the reference (Sunscreen's ``src/lib.rs:3-45``).  Stable
i32 codes are part of the C ABI and of the byte-level precompile contract, so
they are reproduced exactly; tests/test_torch_bytes.py holds them equal.
"""
from __future__ import annotations

import enum


class FheErrorCode(enum.IntEnum):
    """Stable error codes (reference: src/lib.rs:14-27)."""

    UNEXPECTED_EOF = 1
    PLATFORM_ARCHITECTURE = 2
    INVALID_ENCODING = 3
    OVERFLOW = 4
    FAILED_DECRYPTION = 5
    FAILED_ENCRYPTION = 6
    RUNTIME_ERROR = 7  # reference: SunscreenError


_ERROR_STRINGS = {
    # Strings mirror the reference (src/lib.rs:33-44) for C-ABI parity.
    1: "Unexpected end of file",
    2: "Platform architecture invalid",
    3: "Invalid encoding",
    4: "Overflow in FHE program",
    5: "Invalid decryption",
    6: "Invalid encryption",
    7: "Base sunscreen error",
}


def error_code_to_str(error_code: int) -> str:
    """Map an error code to a human-readable string (src/lib.rs:29-45)."""
    return _ERROR_STRINGS.get(error_code, "Unknown error")


class FheError(Exception):
    """Exception carrying a stable :class:`FheErrorCode`.

    The byte-level API (``app.FheApp``) catches these and converts them to
    error codes at the C boundary, exactly like ``PrecompileResult`` in the
    reference (src/lib.rs:52).
    """

    def __init__(self, code: FheErrorCode, message: str | None = None):
        self.code = FheErrorCode(code)
        super().__init__(message or error_code_to_str(int(code)))


def unexpected_eof(msg: str = "") -> FheError:
    return FheError(FheErrorCode.UNEXPECTED_EOF, msg or None)


def invalid_encoding(msg: str = "") -> FheError:
    return FheError(FheErrorCode.INVALID_ENCODING, msg or None)


def overflow(msg: str = "") -> FheError:
    return FheError(FheErrorCode.OVERFLOW, msg or None)


def failed_decryption(msg: str = "") -> FheError:
    return FheError(FheErrorCode.FAILED_DECRYPTION, msg or None)


def failed_encryption(msg: str = "") -> FheError:
    return FheError(FheErrorCode.FAILED_ENCRYPTION, msg or None)
