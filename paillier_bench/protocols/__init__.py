"""The protocols a traffic mix can drive, one module each.

A mix's data file names its protocol (``"protocol": "fl_aggregate"``),
and the harness imports ``paillier_bench.protocols.<protocol>``. Each
module has ``Mix(config, traffic, seed, device, tracer, control)`` with
the configuration's dict (the key and the deployment's scale) and the
mix's, and:

* ``unit``: what a step completes ("values");
* ``setup()``: the keys' device contexts (and what the protocol does
  once, such as encrypting a model); ``warm()``: two calls of every
  shape the mix uses, each program's warm-up and its capture;
* ``prepare(i)`` then ``step(i, data)``: step i's inputs from the seed,
  and the step itself through the program's entry points, ending with the
  plaintexts on the host; it returns the units completed;
* ``least(i)``: step i's least work as (operations, bytes), from sizes
  alone (``paillier_bench.leastwork``);
* ``export()``: after the window, the sampled outputs read back through
  the program's own export, so that its device state can go;
* ``check(steps)``: the comparison with ``paillier_bench.reference``,
  {name: (reading, limit)}.

``control`` swaps in a control of the check (never in a benchmark run):
"float32" gives the program float32-rounded inputs, "no_obfuscation"
encrypts with r = 1 where the mix encrypts (the clients' gradients).
"""

import numpy as np


def seed_words(seed):
    """A seed of any sign and size as SeedSequence entropy."""
    seed = int(seed)
    words = [abs(seed) & 0xFFFFFFFF, (abs(seed) >> 32) & 0xFFFFFFFF]
    return words + [1 if seed < 0 else 0]


def rng(seed, *stream):
    """The generator of one named stream of the seed's inputs."""
    return np.random.default_rng(seed_words(seed) + [int(s) for s in stream])


def key_pair(config):
    """The program's key pair from the configuration's primes."""
    from phe_tpu_torch.keys import PaillierPrivateKey, PaillierPublicKey

    p, q = int(config["p"], 16), int(config["q"], 16)
    pub = PaillierPublicKey(p * q)
    return pub, PaillierPrivateKey(pub, p, q)
