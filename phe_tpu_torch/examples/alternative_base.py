"""Using an alternative encoding base (reference: examples/alternative_base.py).

EncodedNumber's BASE class attribute is subclassable; parties agreeing on a
different radix (here 64) interoperate as long as both sides use the same
Encoding class for encode and decode, including odd bases, which exercise
the exact-rational rounding path (docs/caveats.rst:20-37 in the reference).

Run:  python -m phe_tpu_torch.examples.alternative_base [--device cpu]
"""

import argparse
import math

import phe_tpu_torch
from phe_tpu_torch.batch import EncryptedBatch
from phe_tpu_torch.encoding import EncodedNumber


class Base64Number(EncodedNumber):
    BASE = 64
    LOG2_BASE = math.log(BASE, 2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the batch path (default: cuda)")
    args = ap.parse_args(argv)

    pub, priv = phe_tpu_torch.generate_paillier_keypair(n_length=512)

    value = 2.718281828459045
    encoded = Base64Number.encode(pub, value)
    print("base-64 exponent:", encoded.exponent)

    enc = pub.encrypt(encoded)
    dec = priv.decrypt_encoded(enc, Encoding=Base64Number)
    assert dec.decode() == value
    print("roundtrip OK:", dec.decode())

    # Batch path with a custom Encoding class
    values = [1.5, -2.25, 1e-4]
    batch = EncryptedBatch.encrypt(
        pub, [Base64Number.encode(pub, v) for v in values], device=args.device
    )
    out = batch.decrypt(priv, Encoding=Base64Number)
    assert out == values
    print("batch roundtrip OK:", out)


if __name__ == "__main__":
    main()
