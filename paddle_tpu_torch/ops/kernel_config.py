"""Kernel dispatch configuration: the one owner of the flash-vs-dense
attention decision.

Parity: the JAX package's ops/kernel_config.py (`flash_at`,
`flash_min_seq`). Kept: the structural decode rule (a query length <= 1 is
dense by construction) and the FLAGS_flash_min_seq pin. The default
crossover here is 0 — flash for every query length above 1 — because the
JAX default (1024) was measured on a TPU and says nothing about this card;
measuring the crossover on the H100 is later work. Until it is measured,
the pin selects the dense path only on the CPU: on the card a pin that
would send a query length above 1 to the dense path raises instead of
silently bypassing the flash kernel. The TPU tile table and the
PADDLE_TPU_PALLAS switch have no counterpart here.
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


def flash_at(q_len, device_type="cpu"):
    """The one flash-vs-dense decision for fused_attention at query length
    `q_len` (None when unknown) on a tensor of `device_type`. q_len <= 1
    (decode-shaped: one query row per step) is always dense; otherwise
    flash when q_len >= flash_min_seq(). On "cuda" a q_len above 1 that
    the pin would send to the dense path raises: the crossover on the card
    is unmeasured, so the pin may not turn the flash kernel off there."""
    if q_len is not None and q_len <= 1:
        return False
    if q_len is None:
        return True
    min_seq = flash_min_seq()
    if q_len >= min_seq:
        return True
    if device_type == "cuda":
        raise RuntimeError(
            "FLAGS_flash_min_seq=%d would send fused_attention at q_len %d "
            "to the dense path on the card; the flash/dense crossover is "
            "not measured on CUDA, so unset the flag or set it <= %d"
            % (min_seq, q_len, q_len))
    return False
