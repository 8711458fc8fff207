"""Federated gradient aggregation, python-paillier's example protocol.

examples/federated_learning_with_encryption.py:195-231: each client
encrypts its gradient under the server's key, the aggregator multiplies
the encrypted vectors coordinate by coordinate, and the key holder
decrypts only the sum. The deployment's scale is the configuration's:
``parameters`` coordinates an update, ``clients_per_round`` clients, and
a client sends its update in calls of ``coordinates_per_call``
coordinates (a round is ceil(parameters / coordinates_per_call) calls,
the last one shorter). One step is one call's coordinates from each of
the round's clients, through ``EncryptedBatch.encrypt`` per client,
``models.federated.aggregate_encrypted_gradients`` (the exponent
alignment and the tree of products) and ``EncryptedBatch.decrypt``. The
gradients are float64 from normal(0, gradient_sigma), drawn per call from
the seed, every magnitude as drawn.

The check: every coordinate of every finished step decrypts to the exact
encoded sum of the clients' values (python-paillier's arithmetic), and a
sample of the aggregates' and the clients' ciphertexts, drawn from the
seed, decrypts under the plain reference to the expected residue at the
expected exponent and carries an obfuscator.
"""

import numpy as np

from paillier_bench import leastwork
from paillier_bench.protocols import key_pair, rng
from paillier_bench.reference import paillier as ref

LIMITS = {"plain_wrong": 0, "cipher_wrong": 0, "unblinded": 0}
# The ciphertext sample: the steps kept on the card (every KEEP_EVERY-th
# from an offset drawn from the seed, at most KEEP_MAX of them) and the
# number of aggregate and of client ciphertexts read back from them.
KEEP_EVERY, KEEP_MAX, CIPHERTEXTS = 2, 2, 16
_WARM = 1 << 30  # the stream of the warm-up's values


class Mix:
    unit = "values"

    def __init__(self, config, traffic, seed, device, tracer, control=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.tracer, self.control = device, tracer, control
        self.clients = int(config["clients_per_round"])
        self.per_call = int(config["coordinates_per_call"])
        self.params = int(config["parameters"])
        self.calls = -(-self.params // self.per_call)
        self.pub, self.priv = key_pair(config)
        self.key = ref.Key(int(config["p"], 16), int(config["q"], 16))
        self.keep_offset = int(rng(seed, 2).integers(KEEP_EVERY))
        self.outputs = {}  # step -> decrypted sums
        self.kept = {}  # step -> (client batches, aggregate), on the card
        self.exported = {}  # step -> {(client or -1, coordinate): (c, exp)}

    def width(self, i):
        """Coordinates a client sends in step i."""
        k = i % self.calls
        return min(self.per_call, self.params - k * self.per_call)

    def values(self, i, stream=0):
        """[clients, coordinates] gradients of step i's call."""
        rnd, k = divmod(i, self.calls)
        return rng(self.seed, stream, rnd, k).normal(
            0.0, float(self.traffic["gradient_sigma"]),
            (self.clients, self.width(i)))

    def setup(self):
        self.pub.device_context(self.device).rstate()
        self.priv.device_context(self.device).rstate()

    def warm(self):
        """Every call width of a round: two clients' encrypts (a warm-up
        call, then its capture), and the round's clients, two batches
        over, aggregated and decrypted twice."""
        for width in sorted({self.width(i) for i in range(self.calls)}):
            i = next(i for i in range(self.calls) if self.width(i) == width)
            batches = self._encrypt(self.values(i, _WARM)[:2])
            batches = [batches[c % 2] for c in range(self.clients)]
            for _ in range(2):
                self._aggregate(batches)

    def prepare(self, i):
        g = self.values(i)
        if self.control == "float32":
            g = g.astype(np.float32).astype(np.float64)
        return g

    def _encrypt(self, g):
        from phe_tpu_torch.batch import EncryptedBatch

        obfuscation = "none" if self.control == "no_obfuscation" else "exact"
        with self.tracer.span("fl.encrypt"):
            return [EncryptedBatch.encrypt(self.pub, row.tolist(),
                                           obfuscation=obfuscation,
                                           device=self.device)
                    for row in g]

    def _aggregate(self, batches):
        from phe_tpu_torch.models.federated import (
            aggregate_encrypted_gradients)

        with self.tracer.span("fl.aggregate"):
            aggregate = aggregate_encrypted_gradients(batches)
        with self.tracer.span("fl.decrypt"):
            return aggregate, aggregate.decrypt(self.priv)

    def step(self, i, g):
        batches = self._encrypt(g)
        aggregate, self.outputs[i] = self._aggregate(batches)
        if i % KEEP_EVERY == self.keep_offset and len(self.kept) < KEEP_MAX:
            self.kept[i] = (batches, aggregate)
        return g.size

    def _encoded(self, i):
        mant, exps = ref.encode_array(self.values(i))
        return mant, exps, exps.min(axis=0)

    def least(self, i):
        _, exps, target = self._encoded(i)
        diff = exps - target
        align_bits = np.where(diff > 0, 4 * diff + 1, 1)
        return leastwork.fl_step(self.key.n.bit_length(),
                                 self.key.p.bit_length(),
                                 self.key.q.bit_length(), self.clients,
                                 exps.shape[1], align_bits)

    def export(self):
        """The sampled ciphertexts as integers, through the program's own
        export (be_secure=False: as they are, not re-obfuscated)."""
        pick = rng(self.seed, 3)
        steps = sorted(self.kept)
        wanted = {}  # (step, client or -1) -> coordinates
        for n in range(CIPHERTEXTS if steps else 0):
            i = steps[n % len(steps)]
            j = int(pick.integers(len(self.kept[i][1])))
            wanted.setdefault((i, -1), []).append(j)
            c = int(pick.integers(self.clients))
            wanted.setdefault((i, c), []).append(j)
        for (i, c), coords in wanted.items():
            batches, aggregate = self.kept[i]
            batch = aggregate if c < 0 else batches[c]
            ints = batch.ciphertext_ints(be_secure=False)
            out = self.exported.setdefault(i, {})
            for j in coords:
                out[c, j] = (ints[j], int(batch.exponents[j]))
        self.kept.clear()

    def check(self, steps):
        plain_wrong = cipher_wrong = unblinded = 0
        for i in steps:
            mant, exps, target = self._encoded(i)
            totals = ref.aligned_sums(mant, exps)
            sums = self.outputs[i]
            plain_wrong += abs(len(sums) - len(totals))
            plain_wrong += sum(got != ref.decode(total, int(e))
                               for got, total, e in zip(sums, totals, target))
            for (c, j), (ct, exp) in self.exported.get(i, {}).items():
                want = ((totals[j], int(target[j])) if c < 0
                        else (int(mant[c, j]), int(exps[c, j])))
                cipher_wrong += (self.key.decrypt(ct)
                                 != self.key.residue(want[0])
                                 or exp != want[1])
                unblinded += not self.key.blinded(ct)
        return {"plain_wrong": (plain_wrong, LIMITS["plain_wrong"]),
                "cipher_wrong": (cipher_wrong, LIMITS["cipher_wrong"]),
                "unblinded": (unblinded, LIMITS["unblinded"])}
