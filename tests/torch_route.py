"""The port tests' one way onto the limb engine: make ``rns.fits`` refuse
a modulus, as it refuses n^2 of a key past ~4,380 bits."""

from phe_tpu_torch.ops import rns


def refuse_rns(monkeypatch, above_bits=0):
    """rns.fits refuses every modulus above ``above_bits`` bits (by
    default every modulus). Contexts built after this take the limb
    engine for those moduli; contexts already built keep their route."""
    real = rns.fits
    monkeypatch.setattr(rns, "fits", lambda modulus, *a: (
        int(modulus).bit_length() <= above_bits and real(modulus, *a)))
