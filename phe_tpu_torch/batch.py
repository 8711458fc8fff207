"""Batch-first Paillier: ciphertext batches as Montgomery limb tensors.

The PyTorch counterpart of phe_tpu/batch.py for the encrypt -> decrypt
round trip. A batch of B ciphertexts lives on one device as ``int64[Bp, L]``
limbs in the Montgomery domain mod n^2 (Bp: B rounded up to a power-of-two
bucket, padded with identity rows), and:

* fresh encryption is nude = n*m + 1 (the g = n+1 shortcut,
  phe/paillier.py:132-134) times the obfuscator r^n, with r^n on the RNS
  ladder and the limb products in the Montgomery kernel;
* decryption is CRT with exponents p-1, q-1 over p^2, q^2
  (phe/paillier.py:346-353) on two RNS ladders, then the Hensel L-function,
  the hp/hq products and the CRT recombination on the device, and a compact
  decode that ships 3 words per element to the host.

The port runs one engine, RNS, on every key it supports; a key whose n^2
needs more channel primes than exist raises NotImplementedError (see
rns._channels). Encoding exponents are host-side numpy metadata. Blinding
factors r come from the host CSPRNG (``secrets``), never from a torch
generator.
"""

import functools
import secrets
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from phe_tpu_torch.encoding import EncodedNumber
from phe_tpu_torch.ops import limb_math as lm
from phe_tpu_torch.ops import montgomery as mg
from phe_tpu_torch.ops import rns
from phe_tpu_torch.utils import limbs as hl

# Window of the CRT decrypt ladders (1024-bit exponents at 2048-bit keys:
# 1262 products per half) and of the encrypt / obfuscate ladder (2048-bit
# exponent n: 2492 products).
DECRYPT_WINDOW = 5
ENCRYPT_WINDOW = 5
_MIN_BUCKET = 4


def bucket_rows(b):
    """Smallest power-of-two row count >= b (min 4)."""
    return max(_MIN_BUCKET, 1 << (b - 1).bit_length()) if b > 1 else _MIN_BUCKET


def _pad_list(values, target, fill):
    values = list(values)
    return values + [fill] * (target - len(values))


def _bytes_to_ints(rows):
    """[B, nbytes] uint8 (tensor or array) -> Python ints, one per row."""
    rows = rows.cpu().numpy() if torch.is_tensor(rows) else np.asarray(rows)
    return [
        int.from_bytes(rows[i].tobytes(), "little")
        for i in range(rows.shape[0])
    ]


def _fit_limbs(wide, L):
    """Pad or truncate the trailing limb axis to exactly L limbs.

    Truncation is exact for RNS ladder outputs (value <= kN + 1, far
    below 2^(14 L - 16) by the context's headroom).
    """
    W = wide.shape[-1]
    if W < L:
        return F.pad(wide, (0, L - W))
    return wide[..., :L].contiguous()


def _export(mont, ctx):
    """Montgomery -> canonical residues, packed to bytes on the device."""
    return lm.pack_bytes(mg.export_canonical(mg.from_mont(mont, ctx), ctx))


class RnsPubState(NamedTuple):
    """RNS engine handle for one public modulus.

    exit_r: stored residues of R mod N — the exit constant that lands
      ladder outputs directly in the limb Montgomery domain.
    red: mg.ExcessReducer absorbing the ladder's +jN offset (j <= k).
    phe_tpu's state also carries entry_mont, the entry constant of the
    per-element ladder (scalar multiply), which a later slice ports.
    """

    rsys: rns.RNSSystem
    conv: rns.RNSConversion
    exit_r: torch.Tensor
    red: mg.ExcessReducer


def _rns_pow_to_mont(base_limbs, digits, st, ctx, window):
    """RNS-ladder modexp landing canonical in the Montgomery domain.

    base_limbs: [B, Lin] plain values (< 2kN). The ladder exits through
    R mod N, so the output is base^e * R (Montgomery form) <= kN + 1;
    reduce_excess absorbs the +jN offset.
    """
    wide = rns.pow_shared(base_limbs, digits, st.conv, st.rsys,
                          window=window, exit_res=st.exit_r)
    return _fit_limbs(mg.reduce_excess(wide, st.red), ctx.num_limbs)


def _nude_raw(m, nr2, ctx):
    """(n*m + 1) in Montgomery form for encoded residues m < n.

    One shared-operand Montgomery product by nr2 = n*R^2 mod n^2
    (m*nr2*R^-1 = n*m*R), then a limbwise add of R mod n^2.
    """
    m_pad = F.pad(m, (0, ctx.num_limbs - m.shape[-1]))
    prod = mg.mont_mul_const(m_pad, nr2, ctx)  # n*m*R mod n^2, < 1.01 M
    return lm.add(prod, ctx.one.expand(prod.shape))  # < 2.01 M


def _encrypt_rns(m_bytes, r_bytes, nr2, n_digits, ctx, st, ln):
    """Fresh encryption (n*m + 1) * r^n mod n^2, Montgomery form."""
    m = lm.unpack_bytes(m_bytes, ln)
    r = lm.unpack_bytes(r_bytes, ctx.num_limbs)
    nude = _nude_raw(m, nr2, ctx)
    obf = _rns_pow_to_mont(r, n_digits, st, ctx, ENCRYPT_WINDOW)
    return mg.mont_mul(nude, obf, ctx)


def _obfuscate_rns(mont, r_bytes, n_digits, ctx, st):
    """Re-obfuscation ct * r^n mod n^2 (phe/paillier.py:603-624)."""
    r = lm.unpack_bytes(r_bytes, ctx.num_limbs)
    obf = _rns_pow_to_mont(r, n_digits, st, ctx, ENCRYPT_WINDOW)
    return mg.mont_mul(mont, obf, ctx)


def _lfunction_half(xc, ctxh, cm_pinv, h_limbs):
    """L(x, p) * h mod p for one CRT leg, from canonical x = c^(p-1) mod p^2.

    The L function is an exact Hensel division: (x-1)/p = (x-1) * p^-1
    mod 2^(14*Lh), exact because the quotient is < p < 2^(14*Lh).
    """
    t = xc[..., : ctxh.num_limbs]
    tm1 = lm.add(t, torch.full_like(t, lm.LIMB_MASK))  # t - 1 mod R_h
    # const_mul is exact only mod R_h; normalize pins the redundant
    # truncation to exactly (x-1)/p < R_h.
    lfun = lm.normalize(mg.const_mul(tm1, cm_pinv))
    hm = mg.mont_mul(
        mg.to_mont(lfun, ctxh), h_limbs.expand(lfun.shape).contiguous(), ctxh
    )  # = L * h mod p (plain domain: one to_mont, one REDC)
    return mg.export_canonical(hm, ctxh)


def _gt_const(x, comp):
    """Per-row indicator value(x) > T, for canonical x and comp = R-1-T."""
    s = F.pad(x, (0, 1)) + F.pad(comp.expand(x.shape), (0, 1))
    return lm.normalize(s)[..., -1]


def _decode_compact(m, pk):
    """Device half of float/int decoding: sign window + 64-bit mantissa.

    m: [B, W] plaintext residue limbs (< n). Emits int64 [B, 3] rows
    (mant_lo32, mant_hi32, flags): flags bit 0 = decodable (inside a sign
    window), bit 1 = negative window, bit 2 = |mantissa| < 2^64. The host
    finishes decoding and falls back to the exact bigint decode for rows
    with any flag unset.
    """
    m = lm.normalize(m)
    rc = torch.full_like(m, lm.LIMB_MASK) - m
    rc[..., 0] += 1  # R - m (redundant limbs <= 2^14)
    # n - m: the R excess carries out of the top limb, which normalize drops.
    nm = lm.normalize(pk.n_w.expand(m.shape) + rc)
    pos = _gt_const(m, pk.maxc_w) == 0  # m <= max_int
    negf = _gt_const(nm, pk.maxc_w) == 0  # n - m <= max_int
    ok = pos | negf
    mant = torch.where(negf[..., None], nm, m)
    w0 = mant[..., 0] | (mant[..., 1] << 14) | ((mant[..., 2] & 0xF) << 28)
    w1 = (
        (mant[..., 2] >> 4)
        | (mant[..., 3] << 10)
        | ((mant[..., 4] & 0xFF) << 24)
    )
    fits = (mant[..., 4] < 256) & (mant[..., 5:] == 0).all(dim=-1)
    flags = ok.long() | (negf.long() << 1) | (fits.long() << 2)
    return torch.stack([w0, w1, flags], dim=-1)


def _crt_recombine(mp, mq, pk):
    """mp + p*((q + mq - mp) p^-1 mod q) -> canonical plaintext limbs."""
    neg_mp = torch.full_like(mp, lm.LIMB_MASK) - mp
    neg_mp[..., 0] += 1  # R_h - mp (mp canonical)
    # q + mq + (R_h - mp) lies in [R_h, R_h + 2q): full normalisation drops
    # exactly one R_h out of the top limb.
    diff = lm.normalize(pk.q_limbs.expand(mq.shape) + mq + neg_mp)
    u = mg.export_canonical(
        mg.mont_mul(
            mg.to_mont(diff, pk.ctx_hq),
            pk.pinvq_limbs.expand(diff.shape).contiguous(),
            pk.ctx_hq,
        ),
        pk.ctx_hq,
    )
    # m = mp + p * u (< p*q = n): p is a per-key constant, so the full
    # product is one digit matmul (out = 2*Lh covers p*u exactly).
    prod = mg.const_mul(u, pk.cm_pfull)
    m = lm.add(prod, F.pad(mp, (0, prod.shape[-1] - mp.shape[-1])))
    return lm.normalize(m)


def _decrypt_residue_rns(ct_mont, pub_ctx, pk, half_p, half_q):
    """CRT decryption with both half-width modexps on the RNS ladder.

    The wide ciphertext residue folds into each prime-square range
    (mod_reduce) and enters the limb Montgomery domain before conversion to
    residues; the extra R factor leaves through the ladder's exit constant
    E = R^(1-p): (xR)^(p-1) * R^(1-p) = x^(p-1), the plain value the
    L-function needs. half_*: (RNSSystem, RNSConversion, exit_res,
    ExcessReducer) per prime square.
    """
    plain = mg.from_mont(ct_mont, pub_ctx)
    halves = []
    for ctx2, red, ddig, (rsys, conv, ers, red2), ctxh, cm_pinv, h_limbs in (
        (pk.ctx_p, pk.red_p, pk.dp_digits, half_p, pk.ctx_hp,
         pk.cm_pinv_p, pk.hp_limbs),
        (pk.ctx_q, pk.red_q, pk.dq_digits, half_q, pk.ctx_hq,
         pk.cm_pinv_q, pk.hq_limbs),
    ):
        x = mg.mod_reduce(plain, ctx2, red)  # [B, L2+1], value < 1.51 R
        # Montgomery entry: the top limb t has weight R and t <= 1, so
        # x*R^2*R^-1 = REDC(x_lo * R^2) + t * R^2 — one shared-operand
        # product plus a limbwise add; value <= 3.01 p^2, inside the
        # ladder's 2kN input bound.
        L2 = ctx2.num_limbs
        xm = lm.add(
            mg.mont_mul_const(x[..., :L2].contiguous(), ctx2.r2, ctx2),
            x[..., L2:] * ctx2.r2,
        )
        wide = rns.pow_shared(
            xm, ddig, conv, rsys, window=DECRYPT_WINDOW, exit_res=ers
        )
        # The ladder output is the plain x^(p-1) + j p^2; reduce_excess
        # lands it canonical < p^2.
        xc = _fit_limbs(mg.reduce_excess(wide, red2), L2)
        halves.append(_lfunction_half(xc, ctxh, cm_pinv, h_limbs))
    return _crt_recombine(halves[0], halves[1], pk)


class PublicDeviceContext:
    """Per-public-key constants on one device, and the encrypt programs."""

    def __init__(self, public_key, device):
        self.public_key = public_key
        self.device = device
        n = public_key.n
        self.n = n
        self.n_bits = n.bit_length()
        self.ctx = mg.build_context(public_key.nsquare, device)
        self.L = self.ctx.num_limbs  # limbs of the mod-n^2 engine
        self.Ln = hl.num_limbs_for_bits(self.n_bits)  # packing width, m < n
        # Digit schedule of the public exponent n (obfuscator r^n).
        self.n_digits = torch.as_tensor(
            mg.exponent_digits(n, self.n_bits, ENCRYPT_WINDOW), device=device
        )
        # n * R^2 mod n^2: the shared operand of the (n*m + 1) prologue.
        R = 1 << (lm.LIMB_BITS * self.L)
        nsq = public_key.nsquare
        self.nr2_limbs = mg._tensor(
            hl.int_to_limbs(n * (R * R % nsq) % nsq, self.L), device
        )
        self._rns = None

    def rns_state(self):
        """RnsPubState for modexp mod n^2 (built on first use).

        Raises NotImplementedError when n^2 exceeds the RNS channel prime
        supply (keys above ~4,380 bits).
        """
        if self._rns is None:
            nsq = self.public_key.nsquare
            rsys = rns.build_rns(nsq, self.device)
            R = 1 << (lm.LIMB_BITS * self.L)
            self._rns = RnsPubState(
                rsys=rsys,
                conv=rns.build_conversion(rsys, self.L),
                exit_r=rns.residues(R % nsq, rsys),
                red=mg.build_excess_reducer(nsq, rsys.out_limbs, self.device),
            )
        return self._rns

    # -- packing ---------------------------------------------------------

    def pack_mod_nsquare(self, values):
        """Canonical residues mod n^2 -> Montgomery-domain [Bp, L]."""
        values = _pad_list(values, bucket_rows(len(values)), 1)
        x = mg._tensor(hl.ints_to_limbs(values, self.L), self.device)
        return mg.to_mont(x, self.ctx)

    def export_ints(self, mont):
        """Montgomery-domain [B, L] -> canonical Python ints in [0, n^2)."""
        return _bytes_to_ints(_export(mont, self.ctx))

    def pack_messages(self, encodings, pad_rows=None):
        """Encoded residues m < n -> [Bp, nb] uint8 rows on the device.

        Rows pad with m = 0 (nude ciphertext 1) up to pad_rows or the
        bucket size. Bytes, not limbs: the device unpacks them.
        """
        if pad_rows is None:
            pad_rows = bucket_rows(len(encodings))
        encodings = _pad_list(encodings, pad_rows, 0)
        buf = hl.ints_to_bytes(encodings, (self.n_bits + 7) // 8)
        return torch.as_tensor(buf, device=self.device)

    def random_r_bytes(self, count, r_values=None):
        """[Bp, nb] uint8 blinding bases from the system CSPRNG.

        With r_values given, reproduces the reference bit-for-bit, padding
        to the row bucket with r = 1 (identity obfuscator). The default
        draw is one token_bytes call of (n_bits + 64)-bit raw values: r^n
        with r the raw value is within 2^-64 statistical distance of the
        reference's uniform r in [1, n).
        """
        bucket = bucket_rows(count)
        nbytes = (self.n_bits + 64 + 7) // 8
        if r_values is not None:
            r_values = _pad_list(r_values, bucket, 1)
            need = max(
                nbytes, max((v.bit_length() + 7) // 8 for v in r_values)
            )
            buf = hl.ints_to_bytes(r_values, need)
        else:
            buf = np.frombuffer(
                bytearray(secrets.token_bytes(bucket * nbytes)), dtype=np.uint8
            ).reshape(bucket, nbytes)
        return torch.as_tensor(buf, device=self.device)

    def encrypt_mont(self, encodings, r_values=None):
        """Fresh encryption (n*m+1)*r^n for encoded residues -> [Bp, L]."""
        m = self.pack_messages(encodings)
        r = self.random_r_bytes(len(encodings), r_values)
        return _encrypt_rns(m, r, self.nr2_limbs, self.n_digits, self.ctx,
                            self.rns_state(), self.Ln)

    def obfuscate_mont(self, mont):
        """Fresh uniform re-obfuscation of a Montgomery ciphertext batch."""
        r = self.random_r_bytes(mont.shape[0])
        return _obfuscate_rns(mont, r, self.n_digits, self.ctx,
                              self.rns_state())


class PrivateDeviceConstants(NamedTuple):
    """Per-private-key constants on one device for the decrypt program."""

    ctx_p: mg.MontgomeryContext  # mod p^2
    red_p: mg.ReduceTable
    dp_digits: torch.Tensor  # p-1 digit schedule
    ctx_q: mg.MontgomeryContext  # mod q^2
    red_q: mg.ReduceTable
    dq_digits: torch.Tensor
    ctx_hp: mg.MontgomeryContext  # mod p (half width)
    ctx_hq: mg.MontgomeryContext  # mod q
    cm_pinv_p: mg.ConstMulTable  # * (p^-1 mod 2^(14*Lh))
    cm_pinv_q: mg.ConstMulTable  # * (q^-1 mod 2^(14*Lh))
    cm_pfull: mg.ConstMulTable  # * p, exact full product (CRT recombine)
    hp_limbs: torch.Tensor  # hp canonical [Lh]
    hq_limbs: torch.Tensor
    pinvq_limbs: torch.Tensor  # p^-1 mod q canonical [Lh]
    q_limbs: torch.Tensor  # q canonical [Lh]
    n_w: torch.Tensor  # n canonical [2 Lh] (decode window tests)
    maxc_w: torch.Tensor  # 2^(28 Lh) - 1 - max_int canonical [2 Lh]


class PrivateDeviceContext:
    """Per-private-key constants on one device for batched CRT decryption."""

    def __init__(self, private_key, device):
        self.private_key = private_key
        self.device = device
        pub = private_key.public_key
        self.pub_ctx = pub.device_context(device)
        p, q = private_key.p, private_key.q
        ctx_p = mg.build_context(private_key.psquare, device)
        ctx_q = mg.build_context(private_key.qsquare, device)
        wide = self.pub_ctx.L
        half_bits = max(p.bit_length(), q.bit_length())
        ctx_hp = mg.build_context(p, device)
        ctx_hq = mg.build_context(q, device, num_limbs=ctx_hp.num_limbs)
        Lh = max(ctx_hp.num_limbs, ctx_hq.num_limbs)
        if ctx_hp.num_limbs != Lh:
            ctx_hp = mg.build_context(p, device, num_limbs=Lh)
        Rh = 1 << (lm.LIMB_BITS * Lh)
        pack = lambda v: mg._tensor(hl.int_to_limbs(v, Lh), device)
        digits = lambda e: torch.as_tensor(
            mg.exponent_digits(e, half_bits, DECRYPT_WINDOW), device=device
        )
        self.consts = PrivateDeviceConstants(
            ctx_p=ctx_p,
            red_p=mg.build_reduce_table(private_key.psquare, ctx_p, wide,
                                        device),
            dp_digits=digits(p - 1),
            ctx_q=ctx_q,
            red_q=mg.build_reduce_table(private_key.qsquare, ctx_q, wide,
                                        device),
            dq_digits=digits(q - 1),
            ctx_hp=ctx_hp,
            ctx_hq=ctx_hq,
            cm_pinv_p=mg.build_const_mul(pow(p, -1, Rh), Lh, Lh, device),
            cm_pinv_q=mg.build_const_mul(pow(q, -1, Rh), Lh, Lh, device),
            cm_pfull=mg.build_const_mul(p, Lh, 2 * Lh, device),
            hp_limbs=pack(private_key.hp),
            hq_limbs=pack(private_key.hq),
            pinvq_limbs=pack(private_key.p_inverse),
            q_limbs=pack(q),
            n_w=mg._tensor(hl.int_to_limbs(pub.n, 2 * Lh), device),
            maxc_w=mg._tensor(hl.int_to_limbs(
                (1 << (lm.LIMB_BITS * 2 * Lh)) - 1 - pub.max_int, 2 * Lh
            ), device),
        )
        self._rns = None

    def rns_state(self):
        """Per-prime-square RNS halves for the CRT decrypt modexps.

        Each half is (RNSSystem, RNSConversion, exit_res, ExcessReducer):
        the ladder enters with Montgomery-domain values x*R < 3.01 p^2 and
        exits through E = R^(1-p) mod p^2, landing at the plain x^(p-1).
        """
        if self._rns is None:
            priv = self.private_key
            state = []
            for pp, nsq, ctx2 in (
                (priv.p, priv.psquare, self.consts.ctx_p),
                (priv.q, priv.qsquare, self.consts.ctx_q),
            ):
                rsys = rns.build_rns(nsq, self.device)
                R = 1 << (lm.LIMB_BITS * ctx2.num_limbs)
                E = pow(pow(R, -1, nsq), pp - 1, nsq)
                state.append((
                    rsys,
                    rns.build_conversion(rsys, ctx2.num_limbs),
                    rns.residues(E, rsys),
                    mg.build_excess_reducer(nsq, rsys.out_limbs, self.device),
                ))
            self._rns = tuple(state)
        return self._rns

    def _residue(self, ct_mont):
        half_p, half_q = self.rns_state()
        return _decrypt_residue_rns(ct_mont, self.pub_ctx.ctx, self.consts,
                                    half_p, half_q)

    def raw_decrypt_launch(self, ct_mont):
        """Run the decrypt program: [Bp, nbytes] packed plaintext bytes."""
        return lm.pack_bytes(self._residue(ct_mont))

    def raw_decrypt_batch(self, ct_mont):
        """Exact plaintext residues mod n for a Montgomery ciphertext batch."""
        return _bytes_to_ints(self.raw_decrypt_launch(ct_mont))

    def raw_decrypt_compact(self, ct_mont):
        """(compact decode rows [Bp, 3], full packed bytes) — _decode_compact."""
        m = self._residue(ct_mont)
        return _decode_compact(m, self.consts), lm.pack_bytes(m)


class EncryptedBatch:
    """A batch of Paillier ciphertexts resident on one device.

    Attributes:
      public_key: the shared PaillierPublicKey.
      mont: int64[Bp, L] ciphertexts, Montgomery domain mod n^2 (Bp is the
        bucketed row count; the logical length is len(exponents)).
      exponents: int64 numpy [B], per-element encoding exponents.
      is_obfuscated: whether every element carries fresh r^n blinding
        (the lazy-obfuscation state machine, phe/paillier.py:531-568).
    """

    def __init__(self, public_key, mont, exponents, is_obfuscated=False):
        self.public_key = public_key
        self.mont = mont
        self.exponents = np.asarray(exponents, dtype=np.int64)
        self.is_obfuscated = is_obfuscated

    def __len__(self):
        """Logical batch length (the mont tensor rows are bucket-padded)."""
        return len(self.exponents)

    @property
    def _dc(self):
        return self.public_key.device_context(self.mont.device)

    @classmethod
    def encrypt(cls, public_key, values, precision=None, r_values=None,
                device=None):
        """Encode and encrypt a sequence of ints/floats on ``device``.

        Draws uniform r < n from the host CSPRNG and computes r^n (the
        reference's distribution, phe/paillier.py:136-143). With r_values
        pinned, the ciphertexts are reproducible and not marked obfuscated.
        device: None for CUDA, "cpu" for the plain PyTorch versions.
        """
        dc = public_key.device_context(device)
        if precision is None:
            encodings = EncodedNumber.encode_many(public_key, values)
        else:
            encodings = [
                v if isinstance(v, EncodedNumber)
                else EncodedNumber.encode(public_key, v, precision)
                for v in values
            ]
        exponents = [e.exponent for e in encodings]
        mont = dc.encrypt_mont([e.encoding for e in encodings], r_values)
        return cls(public_key, mont, exponents,
                   is_obfuscated=r_values is None)

    @classmethod
    def from_ciphertext_ints(cls, public_key, ciphertexts, exponents,
                             is_obfuscated=False, device=None):
        """Import raw int ciphertexts (deserialisation boundary)."""
        dc = public_key.device_context(device)
        mont = dc.pack_mod_nsquare(list(ciphertexts))
        return cls(public_key, mont, exponents, is_obfuscated)

    def ciphertext_ints(self, be_secure=True):
        """Raw int ciphertexts, obfuscating first when be_secure.

        Obfuscation persists on this batch (the reference's
        on-first-secure-read state machine): repeated secure exports return
        the same ciphertexts without re-paying the r^n modexp.
        """
        if be_secure and not self.is_obfuscated:
            self.mont = self.obfuscate().mont
            self.is_obfuscated = True
        return self._dc.export_ints(self.mont)[: len(self)]

    def obfuscate(self):
        """Multiply every element by a fresh r^n (phe/paillier.py:603-624)."""
        mont = self._dc.obfuscate_mont(self.mont)
        return EncryptedBatch(self.public_key, mont, self.exponents, True)

    def decrypt(self, private_key, Encoding=None):
        """Decrypt and decode the whole batch.

        With the stock base-16 EncodedNumber the decode finishes on the
        compact device rows (_decode_compact); custom Encoding classes take
        the exact bigint path.
        """
        return self.decrypt_async(private_key, Encoding)()

    def decrypt_async(self, private_key, Encoding=None):
        """Run the device half of decryption now; return a finisher.

        The returned zero-argument callable copies the result to the host
        and completes the decode. ``decrypt`` is ``decrypt_async(...)()``.
        """
        if private_key.public_key != self.public_key:
            raise ValueError(
                "encrypted batch was encrypted against a different key!"
            )
        if Encoding is None:
            Encoding = EncodedNumber
        pdc = private_key.device_context(self.mont.device)
        if Encoding is EncodedNumber and EncodedNumber.BASE == 16:
            compact, full = pdc.raw_decrypt_compact(self.mont)
            return functools.partial(
                self._finish_decrypt_fast, compact, full, Encoding
            )
        packed = pdc.raw_decrypt_launch(self.mont)

        def finish():
            residues = _bytes_to_ints(packed)
            return [
                Encoding(self.public_key, m, int(e)).decode()
                for m, e in zip(residues, self.exponents)
            ]

        return finish

    def _finish_decrypt_fast(self, compact, full, Encoding):
        """Vectorised decode from the compact device rows.

        BASE=16 is a power of two, so decoding is mantissa * 2^(4 e). For
        e < 0, converting the < 2^64 mantissa to float64 rounds half-even
        once and np.ldexp is then exact for normal results — the same single
        rounding as the reference's exact division. The doubly-rounded
        corner (mantissa > 2^53 and a subnormal result), overflow-window
        rows and mantissas >= 2^64 take the exact bigint decode.
        """
        B = len(self)
        c = compact[:B].cpu().numpy()
        flags = c[:, 2]
        mant = c[:, 0].astype(np.uint64) | (c[:, 1].astype(np.uint64) << 32)
        exps = self.exponents
        ok = (flags & 1) != 0
        neg = (flags & 2) != 0
        fits = (flags & 4) != 0
        easy = ok & fits & (
            (mant <= np.uint64(1 << 53)) | (4 * exps + 64 >= -960)
        )
        out = [None] * B
        fl = easy & (exps < 0)
        if fl.any():
            idx = np.nonzero(fl)[0]
            signed = np.where(neg[idx], -1.0, 1.0) * mant[idx].astype(
                np.float64
            )
            vals = np.ldexp(signed, (4 * exps[idx]).astype(np.int32))
            for i, v in zip(idx, vals):
                out[i] = float(v)
        for i in np.nonzero(easy & (exps >= 0))[0]:
            v = int(mant[i]) * 16 ** int(exps[i])
            out[i] = -v if neg[i] else v
        hard = ~easy
        if hard.any():
            ints = _bytes_to_ints(full[:B])
            for i in np.nonzero(hard)[0]:
                out[i] = Encoding(
                    self.public_key, ints[i], int(exps[i])
                ).decode()
        return out
