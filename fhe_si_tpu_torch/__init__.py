"""fhe_si_tpu_torch — the FHE-SI scheme of fhe_si_tpu in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100.

Covers every ring family of fhe_si_tpu (Cooley-Tukey m = 2^a * q^b and
the dense m = p - 1 rings) on both residue lanes (chain primes below
2^20, or below 2^23 where the narrow chain runs out): keygen, encrypt,
decrypt, the adds, scalar and constant multiplies, multiply +
relinearize, automorph and rotation with their key-switch keys, the
reference's two applications with their CLIs, the DoubleCrt / SingleCrt
object API, and the npz and reference-format serializers.  Every tensor
equals the one fhe_si_tpu computes from the same randomness.  The
package imports torch and numpy and nothing of fhe_si_tpu: it keeps its
own copies of the JAX package's host modules (context, sampling,
hostmath, apps/matrix.py, cli/gen_data.py, indexmap.py, refserial.py).
"""
from . import sampling, scheme, state  # noqa: F401
from .context import FheContext  # noqa: F401
from .device import DeviceContext  # noqa: F401
