"""Kernel dispatch configuration: the one owner of the flash-vs-dense
attention decision.

Parity: the JAX package's ops/kernel_config.py (`flash_at`,
`flash_min_seq`). Kept: the structural decode rule (a query length <= 1 is
dense by construction) and the FLAGS_flash_min_seq pin. Added: a second
structural rule, a query length other than the key length is dense (the
flash kernels of both packages take one length for q, k and v; the JAX
package reaches its dense path for such shapes below its crossover, and
its kernel could not take them above it). The default crossover here is
0 — flash for every query length above 1 — because the JAX default (1024)
was measured on a TPU and says nothing about this card. On the H100 the
flash kernel beats the dense path at every query length from 16 to 1024
(chip_smoke.py's `crossover:` lines), so there is no crossover to set.
The pin selects the dense path only on the CPU: on the card a pin that
would send an equal-length query above 1 to the dense path raises
instead of silently bypassing the flash kernel (the two paths also
differ on rows with no valid key: 0 against the mean of v). The TPU tile
table and the PADDLE_TPU_PALLAS switch have no counterpart here.
"""
import os

DEFAULT_FLASH_MIN_SEQ = 0


def flash_min_seq():
    """Flash-vs-dense crossover: FLAGS_flash_min_seq when set (an integer;
    anything else raises ValueError), else DEFAULT_FLASH_MIN_SEQ."""
    env = os.environ.get("FLAGS_flash_min_seq", "")
    if not env:
        return DEFAULT_FLASH_MIN_SEQ
    try:
        return int(env)
    except ValueError:
        raise ValueError("FLAGS_flash_min_seq=%r is not an integer" % env)


def flash_at(q_len, device_type="cpu", k_len=None):
    """The one flash-vs-dense decision for fused_attention at query length
    `q_len` and key length `k_len` (None when unknown) on a tensor of
    `device_type`. Two structural rules come first, on every device:
    q_len <= 1 (decode-shaped: one query row per step) is dense, and so is
    a q_len other than k_len (a decoder attending over a source of another
    padded length). Otherwise flash when q_len >= flash_min_seq(). On
    "cuda" a q_len above 1 that the pin would send to the dense path
    raises: the pin may not turn the flash kernel off there."""
    if q_len is not None and q_len <= 1:
        return False
    if q_len is not None and k_len is not None and q_len != k_len:
        return False
    if q_len is None:
        return True
    min_seq = flash_min_seq()
    if q_len >= min_seq:
        return True
    if device_type == "cuda":
        raise RuntimeError(
            "FLAGS_flash_min_seq=%d would send fused_attention at q_len %d "
            "to the dense path on the card, where the flash kernel is the "
            "faster at every measured length; unset the flag or set it "
            "<= %d"
            % (min_seq, q_len, q_len))
    return False
