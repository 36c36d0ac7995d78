"""Division test cases shared by the CPU tests and the card-only tests."""

import numpy as np


def adversarial_pairs(rng, divisor_bits, n_bits, n):
    """Dividend/divisor pairs that stress the floor boundaries: r = q*D,
    q*D - 1, q*D + D - 1 make the f32 estimate sit exactly on/next to an
    integer, where an unfixed estimate would be off by one."""
    maxv = 1 << n_bits
    divisor = rng.randint(1, 1 << divisor_bits, size=n).astype(np.uint64)
    q = rng.randint(0, 1 << 14, size=n).astype(np.uint64)
    exact = divisor * q
    cases = np.concatenate([
        exact, exact - 1, exact + divisor - 1,
        np.minimum(exact + divisor, maxv - 1),
    ]).astype(np.uint64) % maxv
    divisors = np.concatenate([divisor] * 4)
    return cases.astype(np.int64), divisors.astype(np.int64)
