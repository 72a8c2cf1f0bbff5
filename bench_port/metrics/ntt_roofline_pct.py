"""ntt_roofline_pct (%, higher is better; layer: butterfly NTT kernels,
ops/ntt.py and csrc/ntt.cu).

The least time the card could take for the transforms a block needs under
BEHZ, over the time the ``ntt_kernel`` launches took in the traced window
(``torch.profiler``), per block.  It moves requests_per_s.

The transforms a block needs, with M multiplies on a pool of P ciphertexts
(k ciphertext limbs, nb = k + |Bsk| limbs over q u Bsk, kk key limbs):

* forward over q u Bsk, 2 nb rows a ciphertext: once for each pooled
  ciphertext where the stream pools operands (P <= 2 M, the rule of
  ``RequestStream.run_pooled_fused``), else once for each of the 2 M
  operands;
* inverse over q u Bsk: 3 nb rows a multiply;
* forward over the key primes: k kk rows a multiply (each digit);
* inverse over the key primes: 2 kk rows a multiply.

Each row of n words is read once and written once; each transform's tables
(the moduli, the twiddles and their Shoup words, for the inverse n^-1 and its
Shoup word) are read once a block.  Operations: one 40-bit Shoup product (4
FP64 multiply-adds) for each of the n/2 log2(n) butterflies of a row, and
for the inverse one more for each word.  The bound is the larger of the
bytes over 3.35 TB/s and the multiply-adds over 16.75e12 a second, summed
over the four transforms.
"""
from bench_port import peaks


def transforms(sh):
    """[(inverse, rows, limbs)] of one block."""
    n_mul, k, kk = sh["mix"].get("mul", 0), sh["k"], sh["k_key"]
    nb = k + sh["nbsk"]
    pooled = 0 < n_mul and sh["pool"] <= 2 * n_mul
    prepared = sh["pool"] if pooled else 2 * n_mul
    return [(False, 2 * nb * prepared, nb), (True, 3 * nb * n_mul, nb),
            (False, k * kk * n_mul, kk), (True, 2 * kk * n_mul, kk)]


def block_work(sh):
    """[(bytes, FP64 multiply-adds)] of each transform of one block."""
    n = sh["n"]
    log_n = n.bit_length() - 1
    out = []
    for inverse, rows, limbs in transforms(sh):
        if rows == 0:
            continue
        tables = limbs + 2 * limbs * n + (2 * limbs if inverse else 0)
        nbytes = peaks.WORD_BYTES * (2 * rows * n + tables)
        per_row = n // 2 * log_n * peaks.SHOUP40_FMAS
        if inverse:
            per_row += n * peaks.SHOUP40_FMAS
        out.append((nbytes, rows * per_row))
    return out


def block_bound_s(sh):
    return sum(peaks.bound_s(b, fp64_fmas=f) for b, f in block_work(sh))


def read(obs):
    tr = obs.trace
    if tr is None or tr.blocks < 1:
        return None
    from bench_port.trace import short_name
    seconds = sum(o.seconds for o in tr.device_ops
                  if short_name(o.name).split("<")[0] == "ntt_kernel")
    bound = block_bound_s(obs.shapes) * tr.blocks
    if seconds <= 0 or bound <= 0:
        return None
    return 100.0 * bound / seconds
