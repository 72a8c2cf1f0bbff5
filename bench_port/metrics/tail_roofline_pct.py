"""tail_roofline_pct (%, higher is better; layer: tail kernels, ops/tail.py
and csrc/tail.cu).

The least time the card could take for the five BEHZ tail segments a block
needs, over the time their launches took in the traced window
(``torch.profiler``), the five summed.  It moves requests_per_s.

The work a block needs, with M multiplies on a pool of P ciphertexts (k
ciphertext limbs, |Bsk| = nB + 1, nb = k + |Bsk|, kk key limbs, n words a
row), each input word read once and each output word written once:

* to_bsk_ext: a row of k words in, nb out, for each component of each
  prepared ciphertext: P ciphertexts where the stream pools operands
  (P <= 2 M), else the 2 M operands;
* dyadic: two (2, nb) operands in, (3, nb) out, a multiply;
* floor_sk: (3, nb) in, (3, k) out, a multiply;
* relin_dot: the (k, kk) digits in and (2, kk) out a multiply, and the relin
  keys (k, 2, kk) once a block;
* mod_down: (2, kk) and the (2, k) first components in, (2, k) out, a
  multiply.

Operations are counted product by product as csrc/tail.cu forms them, in
32-bit integer multiply-adds (16.75e12 a second) and, for floor_sk's 40-bit
Shoup products, FP64 multiply-adds (16.75e12 a second).  Each segment's bound
is the largest of its bytes over 3.35 TB/s and its two operation terms; the
bound is their sum.
"""
from bench_port import peaks

TAIL_KERNELS = ("to_bsk_ext_kernel", "dyadic_kernel", "floor_sk_kernel",
                "relin_dot_kernel", "mod_down_kernel")
# floor_sk reduces alpha mod q_i by conditional subtracts up to this many,
# and by one Barrett step beyond (csrc/tail.cu)
MSK_CSUB_STEPS = 3


def block_work(sh):
    """{segment: (bytes, integer multiply-adds, FP64 multiply-adds)} of one
    block."""
    n, k, kk, nbsk = sh["n"], sh["k"], sh["k_key"], sh["nbsk"]
    nB, nb = nbsk - 1, k + nbsk
    M = sh["mix"].get("mul", 0)
    if M == 0:
        return {}
    pooled = sh["pool"] <= 2 * M
    rows = 2 * (sh["pool"] if pooled else 2 * M)
    S, B, L = peaks.SHOUP, peaks.BARRETT, peaks.MUL_LAZY
    steps_msk = max((sh["m_sk"] - 1) // p for p in sh["q_moduli"])
    products = nB * (k + 1) + (nB + 1 + k) + k * (nB + 1)
    w = peaks.WORD_BYTES * n
    return {
        "to_bsk_ext": (w * rows * (k + nb),
                       n * rows * (k * S + k + 1
                                    + nbsk * (k * S + B + 2 * S)), 0),
        "dyadic": (w * M * 7 * nb, n * M * nb * 3 * peaks.MULMOD, 0),
        "floor_sk": (w * 3 * M * (nb + k),
                     n * 3 * M * (k * B if steps_msk > MSK_CSUB_STEPS else 0),
                     n * 3 * M * products * peaks.SHOUP40_FMAS),
        "relin_dot": (w * (M * k * kk + k * 2 * kk + 2 * M * kk),
                      n * M * kk * (2 * k * L + 2 * B), 0),
        "mod_down": (w * M * (2 * kk + 4 * k),
                     n * M * 2 * k * (B + S), 0),
    }


def block_bound_s(sh):
    return sum(peaks.bound_s(*work) for work in block_work(sh).values())


def read(obs):
    tr = obs.trace
    if tr is None or tr.blocks < 1:
        return None
    from bench_port.trace import short_name
    seconds = sum(o.seconds for o in tr.device_ops
                  if short_name(o.name).split("<")[0] in TAIL_KERNELS)
    bound = block_bound_s(obs.shapes) * tr.blocks
    if seconds <= 0 or bound <= 0:
        return None
    return 100.0 * bound / seconds
