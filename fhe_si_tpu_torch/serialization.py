"""Serialization of contexts, keys and ciphertexts (checkpoint/resume).

Counterpart of fhe_si_tpu/serialization.py: the same flat npz archives,
array for array, so a file written by either package loads in the other.
The reference's hand-rolled binary streams (Serialization.h:11-81,
Serialization.cpp:3-119; FHEContext.cpp:45-81) are refserial.py's; here
the durable state is the device tensors.  Reference behaviours kept:
  - contexts persist the prime chain AND the per-prime roots, so the
    transforms rebuild identically on import (FHEContext.cpp:62-81);
  - ciphertexts are forced through ScaleDown before export
    (Serialization.cpp:109-114): only non-tensored limb parts are stored.
Import functions take the DeviceContext the objects will live on, so
their tensors land on its device (the card unless the caller built it on
the CPU).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .context import FheContext
from .device import DeviceContext
from .scheme import Ciphertext, FhePublicKey, FheSecretKey, KeySwitch


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def _load(dev: DeviceContext, path: str, *keys) -> list:
    z = np.load(path)
    return [torch.as_tensor(z[k], device=dev.device) for k in keys]


def export_context(ctx: FheContext, path: str):
    params = dict(m=ctx.m, log_q=ctx.log_q, p=ctx.p, generator=ctx.generator,
                  decomp_size=ctx.decomp_size, xi=ctx.xi, stdev=ctx.stdev)
    np.savez(path, params=json.dumps(params),
             primes=np.asarray(ctx.primes), roots=np.asarray(ctx.roots))


def import_context(path: str) -> FheContext:
    z = np.load(path, allow_pickle=False)
    params = json.loads(str(z['params']))
    return FheContext(primes=[int(q) for q in z['primes']],
                      roots=[int(r) for r in z['roots']], **params)


def export_secret_key(sk: FheSecretKey, path: str):
    np.savez(path, sk_evals=_host(sk.sk_evals))


def import_secret_key(dev: DeviceContext, path: str) -> FheSecretKey:
    return FheSecretKey(dev, *_load(dev, path, 'sk_evals'))


def export_public_key(pk: FhePublicKey, path: str):
    np.savez(path, pk_evals=_host(pk.pk_evals), pk_limbs=_host(pk.pk_limbs))


def import_public_key(dev: DeviceContext, path: str) -> FhePublicKey:
    return FhePublicKey(dev, *_load(dev, path, 'pk_evals', 'pk_limbs'))


def export_keyswitch(ksw: KeySwitch, path: str):
    np.savez(path, matrix_evals=_host(ksw.matrix_evals))


def import_keyswitch(dev: DeviceContext, path: str) -> KeySwitch:
    return KeySwitch(dev, *_load(dev, path, 'matrix_evals'))


def export_ciphertext(ct: Ciphertext, path: str):
    ct = ct.relinearized_view()  # ScaleDown-then-write (Serialization.cpp:109-114)
    np.savez(path, parts=_host(ct.parts))


def import_ciphertext(dev: DeviceContext, path: str) -> Ciphertext:
    return Ciphertext(dev, parts=_load(dev, path, 'parts')[0])
