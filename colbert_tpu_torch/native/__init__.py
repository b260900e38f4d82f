"""The port's C++ host runtime (``csrc/native.cpp``), bound with ctypes.

Counterpart of ``colbert_tpu/native/``: the response serializer, the IVF CSR
pack and the balanced list assignment, under the JAX package's names.  The
library builds with g++ at first use; there is no fallback.
"""

from colbert_tpu_torch.native.lib import balanced_assign, ivf_pack, pickle_triples

__all__ = ["balanced_assign", "ivf_pack", "pickle_triples"]
