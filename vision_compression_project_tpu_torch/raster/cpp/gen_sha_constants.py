#!/usr/bin/env python3
"""Generate sha_constants.h: SHA-256/384/512 round constants and IVs.

The FIPS 180-4 constants are the fractional parts of cube/square roots of
the first primes.  Hard-coding 80x 64-bit hex literals invites silent
typos; deriving them with EXACT integer arithmetic (integer cube/square
roots of p << k) reproduces the spec values bit-for-bit.  Run once; the
emitted header is committed next to this generator.
"""

from pathlib import Path


def primes(n):
    out, c = [], 2
    while len(out) < n:
        if all(c % p for p in out):
            out.append(c)
        c += 1
    return out


def iroot(x, k):
    """floor(x ** (1/k)) by Newton iteration on exact integers."""
    if x == 0:
        return 0
    r = 1 << ((x.bit_length() + k - 1) // k)
    while True:
        nr = ((k - 1) * r + x // r ** (k - 1)) // k
        if nr >= r:
            break
        r = nr
    while r ** k > x:
        r -= 1
    return r


def frac_root(p, k, bits):
    """floor(frac(p ** (1/k)) * 2**bits), exactly."""
    whole = iroot(p, k)
    return iroot(p << (k * bits), k) - (whole << bits)


def fmt(vals, suffix, per_line):
    lines = []
    for i in range(0, len(vals), per_line):
        chunk = ", ".join(f"0x{v:0{16 if suffix == 'ull' else 8}x}{suffix}"
                          for v in vals[i:i + per_line])
        lines.append("    " + chunk + ",")
    return "\n".join(lines)


def main():
    p80 = primes(80)
    k256 = [frac_root(p, 3, 32) for p in p80[:64]]
    h256 = [frac_root(p, 2, 32) for p in p80[:8]]
    k512 = [frac_root(p, 3, 64) for p in p80]
    h512 = [frac_root(p, 2, 64) for p in p80[:8]]
    h384 = [frac_root(p, 2, 64) for p in p80[8:16]]

    out = f"""// Generated by gen_sha_constants.py - do not edit by hand.
// FIPS 180-4 round constants / IVs as exact integer-root fractions.
#pragma once
#include <cstdint>

namespace vcpcrypt {{

static const uint32_t kSha256K[64] = {{
{fmt(k256, 'u', 4)}
}};

static const uint32_t kSha256H[8] = {{
{fmt(h256, 'u', 4)}
}};

static const uint64_t kSha512K[80] = {{
{fmt(k512, 'ull', 2)}
}};

static const uint64_t kSha512H[8] = {{
{fmt(h512, 'ull', 2)}
}};

static const uint64_t kSha384H[8] = {{
{fmt(h384, 'ull', 2)}
}};

}}  // namespace vcpcrypt
"""
    Path(__file__).with_name("sha_constants.h").write_text(out)
    print("wrote sha_constants.h")
    import hashlib
    # Sanity: the SHA-256 IV must match hashlib's view of the algorithm by
    # hashing empty input with a local compression check elsewhere; here we
    # at least confirm the first constants against their published values.
    assert k256[0] == 0x428A2F98 and h256[0] == 0x6A09E667
    assert k512[0] == 0x428A2F98D728AE22 and h512[0] == 0x6A09E667F3BCC908
    assert h384[0] == 0xCBBB9D5DC1059ED8
    print("spot-checks passed")


if __name__ == "__main__":
    main()
