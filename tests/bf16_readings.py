"""The bf16 readings behind ``test_bf16_close_to_reference`` in
``test_torch_gpt_sw3.py`` and ``test_torch_marian.py``: for each family's
tiny seeded checkpoint (model seeds 3 and 8) and four sets of texts (the
test's own ``DOCS`` and three seeded sets with a 30-word text), the largest
gaps between the embeddings of

- ``pb``: the port in bf16, ``pf``: the port in f32,
- ``rb``: the reference in bf16, ``rf``: the reference in f32,

and ``pf`` rounded once to bf16 (what a port that ran f32 and returned bf16
would be off by).  Prints one line a case and the ratio the test holds,
``pb-pf / rb-rf``: how far the port's bf16 departs from f32, against the
reference's own departure (``pf`` equals ``rf`` within 1e-5, so ``pf-rb``
is ``rb-rf``).  A set whose bucket runs past the tiny
checkpoint's 128 positions fails the reference and is skipped.  Not a test
(pytest does not collect it).

    JAX_PLATFORMS=cpu python tests/bf16_readings.py [gpt-sw3|marian ...]
"""

from __future__ import annotations

import os
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import test_torch_gpt_sw3  # noqa: E402
import test_torch_marian  # noqa: E402
from torch_families import twin, write_gpt_sw3, write_marian  # noqa: E402

from lotus_tpu.models import JaxSentenceEncoderRM  # noqa: E402
from lotus_tpu_torch.models import TorchSentenceEncoderRM  # noqa: E402

FAMILIES = {"gpt-sw3": (write_gpt_sw3, test_torch_gpt_sw3), "marian": (write_marian, test_torch_marian)}


def gap(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max())


def readings(family: str) -> None:
    writer, module = FAMILIES[family]
    for model_seed in (3, 8):
        root = tempfile.mkdtemp()
        d = writer(os.path.join(root, "port"), seed=model_seed)
        ref = twin(d, os.path.join(root, "ref"))
        sets = {"DOCS": module.DOCS}
        for s in (7, 9, 11):
            sets[f"texts {s}"] = module.plain_texts(s, 7, 1, 12) + ["", module.plain_texts(s + 1, 1, 30, 30)[0]]
        for label, docs in sets.items():
            try:
                rb = JaxSentenceEncoderRM(model=ref, max_batch_size=4, dtype=jnp.bfloat16)._embed(docs)
            except ValueError:
                print(f"{family} seed {model_seed} {label}: past the reference's positions, skipped", flush=True)
                continue
            rf = JaxSentenceEncoderRM(model=ref, max_batch_size=4)._embed(docs)
            pb = TorchSentenceEncoderRM(model=d, device="cpu", max_batch_size=4, dtype=torch.bfloat16)._embed(docs)
            pf = TorchSentenceEncoderRM(model=d, device="cpu", max_batch_size=4)._embed(docs)
            once = gap(torch.from_numpy(pf).bfloat16().float().numpy(), pf)
            print(f"{family} seed {model_seed} {label}: pb-rb {gap(pb, rb):.3e} rb-rf {gap(rb, rf):.3e} "
                  f"pb-pf {gap(pb, pf):.3e} pf-rounded {once:.3e}; pb-pf/rb-rf {gap(pb, pf) / gap(rb, rf):.2f}",
                  flush=True)


if __name__ == "__main__":
    for name in sys.argv[1:] or list(FAMILIES):
        readings(name)
