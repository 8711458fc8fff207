"""Vertical federated logistic regression: Hardy et al.'s masked gradient.

Hardy et al., arXiv:1711.10677, Algorithm 3, as FATE's HeteroLR runs it
at its default ``batch_size = -1`` (the whole data set a batch). The
deployment's scale is the configuration's: ``rows`` rows of a data set
split between the parties, ``batch_rows`` of them a step (cycled in
order), the host's ``host_features`` and the guest's ``guest_features``
plus the intercept's always-one column, and the labels y in {-1, +1}.
The features are float64 normal(0, feature_sigma) and the labels +1 with
probability positive_rate, drawn once a run from the seed: the data set,
fixed through training. Each step draws theta from normal(0,
theta_sigma) and one mask a coordinate from uniform(-mask_bound,
mask_bound), and runs ``models.hetero_lr.train_step``: [[u_A]] encrypted
(``EncryptedBatch.encrypt``), [[d]] by ``mul_scalars`` and
``add_scalars``, each party's X^T [[d]] by ``matvec``, the masks by
``add_scalars``, and the arbiter's decrypt. A step completes one
gradient coordinate a feature, summed over the batch's rows: ``unit``
"values", rows times features.

The check: every masked coordinate the arbiter decrypted and every
unmasked gradient coordinate of every finished step equals the exact
result of python-paillier's encoded arithmetic
(``paillier_bench.reference.hetero_lr``), and a sample of [[u_A]] and
[[d]] ciphertexts drawn from the seed, with every masked gradient
ciphertext of the kept steps, decrypts under the plain reference to the
expected residue at the expected exponent and carries an obfuscator.
"""

import numpy as np

from paillier_bench import leastwork
from paillier_bench.protocols import key_pair, rng
from paillier_bench.reference import hetero_lr as ref_lr
from paillier_bench.reference import paillier as ref

LIMITS = {"plain_wrong": 0, "cipher_wrong": 0, "unblinded": 0}
# The ciphertext sample: the steps kept on the card (every KEEP_EVERY-th
# from an offset drawn from the seed, at most KEEP_MAX of them) and the
# number of [[u_A]] and of [[d]] ciphertexts read back from them.
KEEP_EVERY, KEEP_MAX, CIPHERTEXTS = 2, 2, 16
_WARM = 1 << 30  # the stream of the warm-up's theta and masks
# Every schedule width (bits, in matvec's buckets of 32) a gradient grid
# takes: 75-94 bits over 5,474 steps of 391 seeds at the configuration's
# scale (96), and the next bucket for the tail.
WIDTHS = (96, 128)


def _bit_length(k):
    """Bit lengths of non-negative int64 values below 2^63."""
    e = np.frexp(k.astype(np.float64))[1].astype(np.int64)
    # A value just under a power of two can round up to it as a float.
    over = np.left_shift(np.int64(1), np.maximum(e - 1, 0)) > k
    return np.where(k > 0, e - over, 0)


def grid_bits(d_exponents, X):
    """[rows, features] bit lengths of X^T [[d]]'s grid exponents,
    |mantissa of x| * BASE ** (its product exponent less the feature's
    least), as matvec forms them; 0 where x encodes to 0."""
    mx, ex = ref.encode_array(X)
    exps = d_exponents[:, None] + ex
    diff = exps - exps.min(axis=0)
    return np.where(mx != 0, _bit_length(np.abs(mx)) + 4 * diff, 0)


def _bucket(bits):
    return -(-int(bits) // 32) * 32


class Mix:
    unit = "values"

    def __init__(self, config, traffic, seed, device, tracer, control=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.tracer, self.control = device, tracer, control
        self.rows = int(config["rows"])
        self.batch = int(config["batch_rows"])
        self.n_host = int(config["host_features"])
        guest = int(config["guest_features"])
        self.features = self.n_host + guest + 1
        self.pub, self.priv = key_pair(config)
        self.key = ref.Key(int(config["p"], 16), int(config["q"], 16))
        X = rng(seed, 0).normal(0.0, float(traffic["feature_sigma"]),
                                (self.rows, self.n_host + guest))
        self.y = np.where(rng(seed, 1).random(self.rows)
                          < float(traffic["positive_rate"]), 1.0, -1.0)
        self.X_host = np.ascontiguousarray(X[:, : self.n_host])
        self.X_guest = np.ascontiguousarray(
            np.hstack([X[:, self.n_host:], np.ones((self.rows, 1))]))
        self.keep_offset = int(rng(seed, 4).integers(KEEP_EVERY))
        self.parties = {}  # batch index -> (host, guest)
        self.outputs = {}  # step -> (masked, gradient): host's then guest's
        self.kept = {}  # step -> train_step's StepResult, on the card
        self.exported = {}  # step -> {(batch name, index): (c, exponent)}
        self.refs = {}  # step -> the reference's Step

    def _slice(self, i):
        k = i % max(self.rows // self.batch, 1)
        return slice(k * self.batch, (k + 1) * self.batch)

    def _rounded(self, a):
        if self.control == "float32":
            return a.astype(np.float32).astype(np.float64)
        return a

    def inputs(self, i, stream=0):
        """(theta, masks) of step i: host's coordinates, then guest's."""
        theta = rng(self.seed, 2, stream, i).normal(
            0.0, float(self.traffic["theta_sigma"]), self.features)
        bound = float(self.traffic["mask_bound"])
        masks = rng(self.seed, 3, stream, i).uniform(-bound, bound,
                                                      self.features)
        return theta, masks

    def _data(self, i):
        rows = self._slice(i)
        return self.X_host[rows], self.X_guest[rows], self.y[rows]

    def _parties(self, X_host, X_guest, y):
        from phe_tpu_torch.models import hetero_lr

        return (hetero_lr.Host(self.pub, self._rounded(X_host), self.device),
                hetero_lr.Guest(self.pub, self._rounded(X_guest), y,
                                self.device))

    def setup(self):
        from phe_tpu_torch.models import hetero_lr

        self.pub.device_context(self.device).rns_state()
        self.priv.device_context(self.device).rns_state()
        self.arbiter = hetero_lr.Arbiter(self.pub, self.priv)
        for k in range(max(self.rows // self.batch, 1)):
            self.parties[k] = self._parties(*self._data(k))

    def _warm_parties(self, width, theta):
        """Parties whose two gradient grids take width at theta: the
        first batch with every |x| raised to at least 1/16 (a narrow
        spread of exponents), then each party's first row scaled by
        BASE ** -t, t raised until its grid reaches the width: a lower
        exponent in the row lowers each feature's least."""
        nh = self.n_host
        X_host, X_guest, y = self._data(0)
        Xs = [np.where(np.abs(X) < 1 / 16, np.copysign(1 / 16, X), X)
              for X in (self._rounded(X_host), self._rounded(X_guest))]
        firsts = [X[0].copy() for X in Xs]
        ts = [0, 0]
        for _ in range(128):
            for X, first, t in zip(Xs, firsts, ts):
                X[0] = first * 16.0 ** -t
            _, d_exps = ref_lr.residual(
                ref_lr.scores(Xs[0], self._rounded(theta[:nh])),
                ref_lr.guest_scalars(Xs[1], self._rounded(theta[nh:]), y))
            got = [_bucket(grid_bits(d_exps, X).max()) for X in Xs]
            if min(got) >= width:
                break
            ts = [t + (g < width) for t, g in zip(ts, got)]
        if got != [width, width]:
            raise RuntimeError("no first-row scales give width %d (got %s)"
                               % (width, got))
        return self._parties(Xs[0], Xs[1], y)

    def warm(self):
        """Two steps at every grid width of WIDTHS (each program's
        warm-up and its capture), on the first batch with its first row
        scaled to reach the width."""
        theta, masks = self.inputs(0, _WARM)
        theta = self._rounded(theta)
        for width in WIDTHS:
            host, guest = self._warm_parties(width, theta)
            for _ in range(2):
                self._train(host, guest, theta, masks)

    def prepare(self, i):
        theta, masks = self.inputs(i)
        return self._rounded(theta), masks

    def _train(self, host, guest, theta, masks):
        from phe_tpu_torch.models import hetero_lr

        nh = self.n_host
        obfuscation = "none" if self.control == "no_obfuscation" else "exact"
        return hetero_lr.train_step(
            self.arbiter, host, guest, theta[:nh], theta[nh:], masks[:nh],
            masks[nh:], obfuscation=obfuscation,
            phase=lambda name: self.tracer.span("vfl." + name))

    def step(self, i, data):
        theta, masks = data
        host, guest = self.parties[i % len(self.parties)]
        r = self._train(host, guest, theta, masks)
        self.outputs[i] = (list(r.plain_host) + list(r.plain_guest),
                           list(r.gradient_host) + list(r.gradient_guest))
        if i % KEEP_EVERY == self.keep_offset and len(self.kept) < KEEP_MAX:
            self.kept[i] = r
        return self.batch * self.features

    def reference(self, i):
        """The reference's Step i, from the unrounded inputs."""
        if i not in self.refs:
            theta, masks = self.inputs(i)
            X_host, X_guest, y = self._data(i)
            nh = self.n_host
            self.refs[i] = ref_lr.step(X_host, X_guest, y, theta[:nh],
                                       theta[nh:], masks[:nh], masks[nh:])
        return self.refs[i]

    def least(self, i):
        """r^n and the product for every row; the 0.25 pow; add_scalars'
        alignment and product; the batch inversion's 3 (B - 1) products;
        every grid element's squarings at its exact exponent bits; the
        trees' D (B - 1) products; the masks' alignment and product; D
        decrypts."""
        s = self.reference(i)
        X_host, X_guest, _ = self._data(i)
        wide, B, D = 2 * self.key.n.bit_length(), self.batch, self.features
        prod = leastwork.product_ops(wide)
        quarter = ref.encode(ref_lr.QUARTER)[0].bit_length()
        e_product = s.u_exponents + ref.encode(ref_lr.QUARTER)[1]
        ops = B * (leastwork.modexp_ops(wide, self.key.n.bit_length())
                   + prod)
        ops += B * leastwork.modexp_ops(wide, quarter)
        ops += leastwork.modexp_ops(
            wide, self._align_bits(e_product - s.d_exponents)) + B * prod
        ops += 3 * (B - 1) * prod
        for X, g in ((X_host, s.host), (X_guest, s.guest)):
            ops += leastwork.modexp_ops(wide, grid_bits(s.d_exponents, X))
            grid_exps = (s.d_exponents[:, None]
                         + ref.encode_array(X)[1]).min(axis=0)
            ops += leastwork.modexp_ops(
                wide, self._align_bits(grid_exps - g.exponents))
        ops += D * (B - 1) * prod + D * prod
        ops += D * leastwork.decrypt_ops(self.key.p.bit_length(),
                                         self.key.q.bit_length())
        # [[u_A]], [[d]] and its inverses each written once and read once;
        # features, u_B and y in, the coordinates out.
        nbytes = 3 * B * 2 * (wide // 8) + B * (D + 2) * 8 + D * 8
        return int(ops), nbytes

    @staticmethod
    def _align_bits(diff):
        return np.where(diff > 0, 4 * diff + 1, 1)

    def export(self):
        """The sampled ciphertexts as integers, through the program's own
        export (be_secure=False: as they are, not re-obfuscated)."""
        pick = rng(self.seed, 5)
        steps = sorted(self.kept)
        wanted = {}  # (step, batch name) -> indices
        for n in range(CIPHERTEXTS if steps else 0):
            i = steps[n % len(steps)]
            for name in ("u", "d"):
                wanted.setdefault((i, name), []).append(
                    int(pick.integers(self.batch)))
        for i in steps:
            wanted[i, "host"] = list(range(self.n_host))
            wanted[i, "guest"] = list(range(self.features - self.n_host))
        for (i, name), rows in wanted.items():
            r = self.kept[i]
            batch = {"u": r.u_host, "d": r.d, "host": r.masked_host,
                     "guest": r.masked_guest}[name]
            ints = batch.ciphertext_ints(be_secure=False)
            out = self.exported.setdefault(i, {})
            for j in rows:
                out[name, j] = (ints[j], int(batch.exponents[j]))
        self.kept.clear()

    def check(self, steps):
        plain_wrong = cipher_wrong = unblinded = 0
        for i in steps:
            s = self.reference(i)
            masked, gradient = self.outputs[i]
            want_masked = s.host.masked + s.guest.masked
            want_gradient = list(s.host.gradient) + list(s.guest.gradient)
            for got, want in ((masked, want_masked),
                              (gradient, want_gradient)):
                plain_wrong += abs(len(got) - len(want))
                plain_wrong += sum(a != b for a, b in zip(got, want))
            expected = {
                "u": (s.u_mantissas, s.u_exponents),
                "d": (s.d_mantissas, s.d_exponents),
                "host": (s.host.totals, s.host.exponents),
                "guest": (s.guest.totals, s.guest.exponents),
            }
            for (name, j), (ct, exp) in self.exported.get(i, {}).items():
                mantissas, exponents = expected[name]
                cipher_wrong += (
                    self.key.decrypt(ct)
                    != self.key.residue(int(mantissas[j]))
                    or exp != int(exponents[j]))
                unblinded += not self.key.blinded(ct)
        return {"plain_wrong": (int(plain_wrong), LIMITS["plain_wrong"]),
                "cipher_wrong": (int(cipher_wrong), LIMITS["cipher_wrong"]),
                "unblinded": (int(unblinded), LIMITS["unblinded"])}
