"""IEEE float32 in the port's float32 forwards (``utils/precision.py``).

cuDNN would run a float32 conv in TF32 by default; the JAX package's
float32 is IEEE. A float32 ``RRDBNet`` or ``SwinIR`` forward must run
every conv with ``torch.backends.cudnn.allow_tf32`` (and cuBLAS's flag)
off and leave both flags as it found them; a bf16 forward leaves them
alone. The flags are plain module attributes, so this holds on the CPU
too: ``F.conv2d`` is patched to record them at each call.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from s2sr_tpu_torch.models import rrdbnet, swinir
from s2sr_tpu_torch.utils.precision import ieee_fp32
from torch_threads import one_torch_thread  # noqa: F401


def _model(family: str, dtype):
    if family == "rrdbnet":
        return rrdbnet.RRDBNet(num_block=1, dtype=dtype).pack()
    return swinir.SwinIR(scale=2, embed_dim=12, depths=(2,), num_heads=(2,),
                         window_size=4, num_feat=64, dtype=dtype).eval().pack()


@pytest.mark.parametrize("family", ["rrdbnet", "swinir"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_scopes_tf32(monkeypatch, family, dtype):
    model = _model(family, dtype)
    seen = []
    conv = F.conv2d

    def recording(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return conv(*args, **kwargs)

    monkeypatch.setattr(F, "conv2d", recording)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    x = torch.from_numpy(np.random.default_rng(0).random((1, 8, 8, 3))
                         .astype(np.float32))
    out = model(x)
    assert out.dtype == torch.float32 and seen
    want = (False, False) if dtype == torch.float32 else (True, True)
    assert set(seen) == {want}
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == (True, True)


def test_ieee_fp32_restores_on_error(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    with pytest.raises(RuntimeError):
        with ieee_fp32():
            assert not torch.backends.cudnn.allow_tf32
            raise RuntimeError("inside")
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == (True, False)
