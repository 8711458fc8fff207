"""State carried across from phe_tpu: its structures as dicts of numpy arrays.

This system runs no model; its "weights" are each key's device constants
and the ciphertext batch itself. Each function here takes one phe_tpu
structure as a dict of numpy arrays (``{name: np.asarray(field)}``, nested
dicts for nested structures) and returns the port's counterpart on
``device``. The port's limb width L equals phe_tpu's for every modulus, so
the Montgomery radix R = 2^(14 L) is the same and ciphertext rows carry
across unchanged.

Limb and residue arrays (uint32 in phe_tpu) become int64 tensors; int8
digit matrices stay int8.
"""

import numpy as np
import torch

from phe_tpu_torch.batch import (
    EncryptedBatch,
    PrivateDeviceConstants,
    RnsPubState,
)
from phe_tpu_torch.ops import montgomery as mg
from phe_tpu_torch.ops import rns


def _t(a, device):
    a = np.array(a)  # a writable copy: jax hands out read-only buffers
    if a.dtype == np.int8:
        return torch.as_tensor(a, device=device)
    return mg._tensor(a, device)


def montgomery_context(d, device):
    """phe_tpu MontgomeryContext. Its int8 REDC matrices and their
    compensation vectors, where d has them, become the context's own, on
    the host (mg.redc_matrices returns them), so both packages reduce with
    the same constants. A context phe_tpu built without them (w_mq None:
    under PHE_TPU_MXU=0, or past its L = 507 ceiling) arrives as an
    ordinary port context, which builds its own at its first int8-body
    launch; the kernels agree with phe_tpu's in value mod M either way."""
    ctx = mg.MontgomeryContext(
        **{f: _t(d[f], device) for f in mg.MontgomeryContext._fields}
    )
    if np.asarray(d.get("w_mq")).dtype == np.int8:
        mg.attach_redc_matrices(ctx, mg.RedcMatrices(
            **{f: _t(d[f], "cpu") for f in mg.RedcMatrices._fields}))
    return ctx


def excess_reducer(d, device):
    """phe_tpu ExcessReducer; its shift geometry rides in pad-array shapes."""
    return mg.ExcessReducer(
        mu=_t(d["mu"], device),
        comp1=_t(d["comp1"], device),
        comp2=_t(d["comp2"], device),
        i0=np.asarray(d["limb_pad"]).shape[0],
        r=np.asarray(d["shift_pad"]).shape[0],
    )


def const_mul_table(d, device):
    return mg.ConstMulTable(w=_t(d["w"], device))


def reduce_table(d, device):
    return mg.ReduceTable(
        powers=_t(d["powers"], device), digit_w=_t(d["digit_w"], device)
    )


def rns_system(d, device):
    return rns.RNSSystem(
        **{f: _t(d[f], device) for f in rns.RNSSystem._fields}
    )


def rns_conversion(d, device):
    return rns.RNSConversion(w=_t(d["w"], device), comp=_t(d["comp"], device))


def rns_pub_state(d, device):
    """phe_tpu RnsPubState (entry_mont included), nested structures as
    dicts."""
    return RnsPubState(
        rsys=rns_system(d["rsys"], device),
        conv=rns_conversion(d["conv"], device),
        entry_mont=_t(d["entry_mont"], device),
        exit_r=_t(d["exit_r"], device),
        red=excess_reducer(d["red"], device),
    )


def private_device_constants(d, device):
    """phe_tpu PrivateDeviceConstants, with nested structures as dicts."""
    kinds = {
        "ctx_p": montgomery_context, "ctx_q": montgomery_context,
        "ctx_hp": montgomery_context, "ctx_hq": montgomery_context,
        "red_p": reduce_table, "red_q": reduce_table,
        "cm_pinv_p": const_mul_table, "cm_pinv_q": const_mul_table,
        "cm_pfull": const_mul_table,
    }
    return PrivateDeviceConstants(**{
        f: kinds[f](d[f], device) if f in kinds else _t(d[f], device)
        for f in PrivateDeviceConstants._fields
    })


def batch_from_limbs(public_key, mont_limbs, exponents, device=None):
    """An EncryptedBatch from phe_tpu's Montgomery rows (uint32 [Bp, L]).

    device: None for CUDA, "cpu" for the plain PyTorch versions.
    """
    dc = public_key.device_context(device)
    mont = _t(mont_limbs, dc.device)
    if mont.dim() != 2 or mont.shape[1] != dc.L:
        raise ValueError(
            "expected [B, %d] Montgomery rows, got shape %s"
            % (dc.L, tuple(mont.shape))
        )
    return EncryptedBatch(public_key, mont.contiguous(), exponents)
