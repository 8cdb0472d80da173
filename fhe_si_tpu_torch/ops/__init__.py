from . import (crt, limbs, modular, ntt, ntt_ct, ntt_ct_cuda,  # noqa: F401
               ntt_ct_matmul)
