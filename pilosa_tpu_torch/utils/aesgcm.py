"""Shared-key AES-GCM for the gossip transport, in the standard library.

A copy of pilosa_tpu/utils/aesgcm.py (the port imports nothing of the
JAX package): AES (FIPS-197) with tables derived at import, GCM (NIST SP
800-38D) with 12-byte nonces and the 16-byte tag appended, derive_key
(the [gossip] secret to an AES-128 key by keyed BLAKE2b), and the
datagram frame seal / open_sealed (version byte, random nonce,
ciphertext and tag). The bytes are the JAX module's for the same key,
nonce and data, so port and JAX nodes gossip with each other. As there,
the `cryptography` package's AESGCM is used when it can be imported (the
same API and bytes); without it (as on the card's machine) every
datagram runs through the pure-Python cipher: a control plane of a few
datagrams a protocol period can afford its cost, a query's path could
not (Gossip counts the seconds it spends sealing and opening).
"""

from __future__ import annotations

import hashlib
import hmac
import os

try:  # the hardened path when the wheel exists (API-compatible)
    from cryptography.hazmat.primitives.ciphers.aead import (  # noqa: F401
        AESGCM as _LibAESGCM,
    )
except ImportError:  # pure-stdlib fallback (this module's reason to exist)
    _LibAESGCM = None


# -- AES core (FIPS-197) ----------------------------------------------------
# Tables are DERIVED, not transcribed: the S-box is the GF(2^8) inverse
# followed by the affine transform, so a typo cannot corrupt the cipher
# silently — any derivation bug fails the known-answer tests loudly.


def _gmul(a: int, b: int) -> int:
    """GF(2^8) multiply modulo x^8 + x^4 + x^3 + x + 1 (0x11B)."""
    r = 0
    for _ in range(8):
        if b & 1:
            r ^= a
        hi = a & 0x80
        a = (a << 1) & 0xFF
        if hi:
            a ^= 0x1B
        b >>= 1
    return r


def _build_sbox() -> bytes:
    exp = [0] * 255
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x = _gmul(x, 3)  # 3 generates the multiplicative group

    out = bytearray(256)
    for v in range(256):
        inv = 0 if v == 0 else exp[(255 - log[v]) % 255]
        s = 0
        for i in range(8):
            bit = ((inv >> i) ^ (inv >> ((i + 4) % 8))
                   ^ (inv >> ((i + 5) % 8)) ^ (inv >> ((i + 6) % 8))
                   ^ (inv >> ((i + 7) % 8)) ^ (0x63 >> i)) & 1
            s |= bit << i
        out[v] = s
    return bytes(out)


_SBOX = _build_sbox()
_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)
# MixColumns multiplier tables (xtime closure, derived)
_MUL2 = bytes(_gmul(v, 2) for v in range(256))
_MUL3 = bytes(_gmul(v, 3) for v in range(256))


def _expand_key(key: bytes) -> tuple[list[list[int]], int]:
    nk = len(key) // 4
    nr = nk + 6
    w = [list(key[4 * i:4 * i + 4]) for i in range(nk)]
    for i in range(nk, 4 * (nr + 1)):
        t = list(w[i - 1])
        if i % nk == 0:
            t = t[1:] + t[:1]
            t = [_SBOX[b] for b in t]
            t[0] ^= _RCON[i // nk - 1]
        elif nk > 6 and i % nk == 4:
            t = [_SBOX[b] for b in t]
        w.append([a ^ b for a, b in zip(w[i - nk], t)])
    return w, nr


def _encrypt_block(w: list[list[int]], nr: int, block: bytes) -> bytes:
    # state is column-major flat: s[4*c + r] (the FIPS input order)
    s = [block[i] ^ w[i // 4][i % 4] for i in range(16)]
    for rnd in range(1, nr + 1):
        # SubBytes + ShiftRows fused: row r rotates left r columns
        t = [0] * 16
        for c in range(4):
            for r in range(4):
                t[4 * c + r] = _SBOX[s[4 * ((c + r) % 4) + r]]
        if rnd < nr:
            u = [0] * 16
            for c in range(4):
                a0, a1, a2, a3 = t[4 * c:4 * c + 4]
                u[4 * c] = _MUL2[a0] ^ _MUL3[a1] ^ a2 ^ a3
                u[4 * c + 1] = a0 ^ _MUL2[a1] ^ _MUL3[a2] ^ a3
                u[4 * c + 2] = a0 ^ a1 ^ _MUL2[a2] ^ _MUL3[a3]
                u[4 * c + 3] = _MUL3[a0] ^ a1 ^ a2 ^ _MUL2[a3]
            t = u
        rk = w[4 * rnd:4 * rnd + 4]
        s = [t[i] ^ rk[i // 4][i % 4] for i in range(16)]
    return bytes(s)


# -- GCM (NIST SP 800-38D) --------------------------------------------------

_R = 0xE1000000000000000000000000000000


def _gf128_mul(x: int, y: int) -> int:
    """GF(2^128) multiply in GCM's reflected representation (alg. 1)."""
    z = 0
    v = x
    for i in range(127, -1, -1):
        if (y >> i) & 1:
            z ^= v
        if v & 1:
            v = (v >> 1) ^ _R
        else:
            v >>= 1
    return z


class AESGCM:
    """AEAD with the `cryptography.hazmat...AESGCM` API surface:
    `encrypt(nonce, data, aad) -> data||tag`, `decrypt` raising
    ValueError on any tag mismatch. 12-byte nonces only (the GCM fast
    path and the only shape the gossip transport emits)."""

    TAG_LEN = 16

    def __init__(self, key: bytes):
        if len(key) not in (16, 32):
            raise ValueError("AESGCM key must be 16 or 32 bytes")
        if _LibAESGCM is not None:
            self._lib = _LibAESGCM(key)
            return
        self._lib = None
        self._w, self._nr = _expand_key(key)
        self._h = int.from_bytes(
            _encrypt_block(self._w, self._nr, b"\x00" * 16), "big")

    def _ctr(self, j0: bytes, n_blocks: int) -> bytes:
        """Keystream: E(K, inc32(J0)), E(K, inc32^2(J0)), ..."""
        out = bytearray()
        prefix, ctr = j0[:12], int.from_bytes(j0[12:], "big")
        for i in range(1, n_blocks + 1):
            blk = prefix + ((ctr + i) & 0xFFFFFFFF).to_bytes(4, "big")
            out += _encrypt_block(self._w, self._nr, blk)
        return bytes(out)

    def _ghash(self, aad: bytes, ct: bytes) -> int:
        y = 0
        for data in (aad, ct):
            for i in range(0, len(data), 16):
                blk = data[i:i + 16]
                if len(blk) < 16:
                    blk = blk + b"\x00" * (16 - len(blk))
                y = _gf128_mul(y ^ int.from_bytes(blk, "big"), self._h)
        lens = (len(aad) * 8).to_bytes(8, "big") \
            + (len(ct) * 8).to_bytes(8, "big")
        return _gf128_mul(y ^ int.from_bytes(lens, "big"), self._h)

    def encrypt(self, nonce: bytes, data: bytes,
                aad: bytes = b"") -> bytes:
        if self._lib is not None:
            return self._lib.encrypt(nonce, data, aad or None)
        if len(nonce) != 12:
            raise ValueError("AESGCM nonce must be 12 bytes")
        j0 = nonce + b"\x00\x00\x00\x01"
        ks = self._ctr(j0, (len(data) + 15) // 16)
        ct = bytes(a ^ b for a, b in zip(data, ks))
        s = self._ghash(aad, ct)
        tag = int.from_bytes(
            _encrypt_block(self._w, self._nr, j0), "big") ^ s
        return ct + tag.to_bytes(16, "big")

    def decrypt(self, nonce: bytes, data: bytes,
                aad: bytes = b"") -> bytes:
        if self._lib is not None:
            try:
                return self._lib.decrypt(nonce, data, aad or None)
            except Exception as e:  # InvalidTag -> one exception type
                raise ValueError(f"AESGCM: {type(e).__name__}") from None
        if len(nonce) != 12:
            raise ValueError("AESGCM nonce must be 12 bytes")
        if len(data) < self.TAG_LEN:
            raise ValueError("AESGCM: ciphertext shorter than the tag")
        ct, tag = data[:-self.TAG_LEN], data[-self.TAG_LEN:]
        j0 = nonce + b"\x00\x00\x00\x01"
        s = self._ghash(aad, ct)
        want = (int.from_bytes(
            _encrypt_block(self._w, self._nr, j0), "big")
            ^ s).to_bytes(16, "big")
        if not hmac.compare_digest(want, tag):
            raise ValueError("AESGCM: tag mismatch")
        ks = self._ctr(j0, (len(ct) + 15) // 16)
        return bytes(a ^ b for a, b in zip(ct, ks))


# -- gossip integration helpers --------------------------------------------

# datagram layout: version byte | 12-byte random nonce | ct+tag. The
# version byte doubles as the is-encrypted discriminator (plaintext JSON
# datagrams start with "{"), so a keyed node drops cleartext instantly.
WIRE_VERSION = 0x01


def derive_key(secret: str) -> bytes:
    """[gossip] secret passphrase -> AES-128 key (keyed BLAKE2b with a
    domain-separation person tag, so the same passphrase used elsewhere
    never yields the same key bytes)."""
    return hashlib.blake2b(secret.encode(), digest_size=16,
                           person=b"pilosa-gssp").digest()


def seal(key: "AESGCM", data: bytes) -> bytes:
    nonce = os.urandom(12)
    return bytes((WIRE_VERSION,)) + nonce + key.encrypt(nonce, data)


def open_sealed(key: "AESGCM", datagram: bytes) -> bytes:
    """Decrypt one sealed datagram; raises ValueError on anything that is
    not a well-formed, authentic ciphertext (caller drops and counts)."""
    if len(datagram) < 1 + 12 + AESGCM.TAG_LEN or \
            datagram[0] != WIRE_VERSION:
        raise ValueError("not an encrypted gossip datagram")
    return key.decrypt(datagram[1:13], datagram[13:])
