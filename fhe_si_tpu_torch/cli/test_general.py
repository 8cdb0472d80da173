"""CLI mirror of Test_General_x (Test_General.cpp:16-101) on the port: a
mixed expression with ciphertext mul, const add/mul, slot rotation with
an automorph keyswitch and negation, checked against Plaintext
arithmetic.

usage: python -m fhe_si_tpu_torch.cli.test_general [p g logQ] [seed]
           [--m=M] [--device=cuda:0|cpu]
(defaults: p=2027 g=3 logQ=120, the reference's hardcoded parameters)

--m=M overrides the ring index (default m = p-1).  When ord_m(p) > 1 the
plaintext slots are GF(p^d) extension fields (PlaintextSpace.cpp:28-59):
messages are then full random GF(p^d) slot vectors, and the plaintext
mirror of the rotation step is the ring automorphism X -> X^(g^k) itself
(Plaintext.automorph), as in fhe_si_tpu/cli/test_general.py.  --device
defaults to cuda:0 and the run refuses to start without CUDA unless
--device=cpu is given.
"""
import sys
import time

import numpy as np

from .. import DeviceContext, FheContext, sampling, scheme
from .common import pick_device


def main(argv):
    m_override, device = None, "cuda:0"
    pos = []
    for a in argv[1:]:
        if a.startswith("--m="):
            m_override = int(a.split("=", 1)[1])
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            pos.append(a)
    device = pick_device(device, "test_general")
    if device is None:
        return 1
    p, g, log_q = (2027, 3, 120)
    if len(pos) >= 3:
        p, g, log_q = int(pos[0]), int(pos[1]), int(pos[2])
    seed = int(pos[3]) if len(pos) > 3 else int(time.time())

    ctx = FheContext(m=m_override if m_override else p - 1, log_q=log_q,
                     p=p, generator=g)
    src = sampling.RandomSource(seed)

    sk, pk = scheme.keygen(DeviceContext(ctx, device), src)
    ksw = scheme.KeySwitch.for_relinearization(sk, src)

    num_slots = ctx.total_slots
    rot_amt = int(src.rng.integers(0, num_slots))
    rot_deg = pow(g, rot_amt, ctx.m)
    auto_ksw = scheme.KeySwitch.for_automorph(sk, rot_deg, src)

    if ctx.slot_degree > 1:
        def rand_pt():
            vecs = src.rng.integers(
                0, p, size=(ctx.total_slots, ctx.slot_degree), dtype=np.int64)
            return scheme.Plaintext.from_slots(ctx, vecs, only_usable=False)
    else:
        def rand_pt():
            return scheme.Plaintext(ctx, src.uniform_mod_p(ctx.phim, p))
    ptxts = [rand_pt() for _ in range(4)]
    const1 = rand_pt()
    const2 = rand_pt()

    c = [pk.encrypt(pt, src) for pt in ptxts]
    p0, p1, p2, p3 = ptxts

    # plaintext side (Test_General.cpp:65-71)
    p1 = p1 * p2
    p0 = p0 + const1
    p2 = p2 * const2
    if ctx.slot_degree > 1:
        p3 = p3.automorph(rot_deg)
    else:
        p3 = p3.rotate(rot_amt)
    p1 = scheme.Plaintext(ctx, (p1.message * -1) % ctx.p)
    p3 = p3 * p2
    p0 = p0 - p3

    # ciphertext side (Test_General.cpp:73-88)
    c[1] = ksw.apply(c[1] * c[2])
    c[0] = c[0] + const1
    c[2] = c[2] * const2
    c[3] = auto_ksw.apply(c[3] >> rot_deg)
    c[1] = c[1] * (-1)
    c[3] = ksw.apply(c[3] * c[2])
    c[0] = c[0] + (c[3] * (-1))

    ok = True
    for i, (ct, pt) in enumerate(zip(c, [p0, p1, p2, p3])):
        got = sk.decrypt(ct).message
        if not np.array_equal(got, pt.message):
            print(f"oops {i}")
            ok = False
    print("All tests finished." + ("" if ok else " (FAILURES)"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
