"""The decode entry on a code whose word only a thread-block cluster holds:
``drivers/decode.py``'s closed loop, inputs and check, with the kernel
source the route launches (the cluster K3, ``csrc/fused_fwd_cl.cu``) built
in set-up, and K3's cluster counters beside the decode's own.  The
counters are the port's cumulative ``fused_fwd_k3.resident_ctas`` and
``.sm_slots``; a program without them leaves them out."""

from __future__ import annotations

from portbench import cells

_decode = cells.driver("decode")

SPAN = _decode.SPAN
SOURCES = ("fused_fwd_cl",)
K3_COUNTERS = ("resident_ctas", "sm_slots")
control = _decode.control


class Driver(_decode.Driver):
    def counters(self) -> dict:
        from neural_ldpc_tpu_torch.ops.cuda import fused_fwd_k3

        out = super().counters()
        for name in K3_COUNTERS:
            if hasattr(fused_fwd_k3, name):
                out[f"k3_{name}"] = getattr(fused_fwd_k3, name)
        return out
