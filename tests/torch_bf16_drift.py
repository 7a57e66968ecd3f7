"""How far a tiny one-stage model's bfloat16 forward drifts from float32,
on the CPU and on the card: each leaf module's output in bfloat16 against
the same model's float32 output on the CPU, as the largest distance over
the largest float32 magnitude, in the order the forward reaches them;
then the largest over the leaves and over the head's last convs on each
device, and at how many leaves the card's sits farther than the CPU's.

    python tests/torch_bf16_drift.py [yolof|yolox|ssd|solo|yolact]

Needs a card; the model, weights and batch are
``test_torch_cuda._onestage5_card_vs_cpu``'s (train mode: the live BNs on
the batch's statistics)."""
import os
import sys

import torch

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]

import test_torch_cuda as cases  # noqa: E402
from oadg_tpu_torch.models import build_detector  # noqa: E402
from oadg_tpu_torch.models.layers import BatchNorm  # noqa: E402


def leaf_outputs(name, where, dtype):
    """The tiny model's forward to its head's outputs on ``where`` in
    ``dtype`` -> ({leaf module: its output in float32 on the CPU}, their
    order, the model's live BNs, the leaves that give the head's
    outputs)."""
    model, seed = cases._seeded5(name)
    det = build_detector(model, device=where, dtype=dtype)
    det.load_state_dict({k: v.to(where) for k, v in seed.state_dict().items()})
    det.train()
    out, order, made = {}, [], {}
    for leaf, m in det.named_modules():
        if leaf and not list(m.children()):
            def keep(mod, args, y, leaf=leaf):
                if torch.is_tensor(y):
                    made[id(y)] = leaf
                    if leaf not in out:
                        out[leaf] = y.detach().float().cpu()
                        order.append(leaf)
            m.register_forward_hook(keep)
    img = cases._onestage_batch()["img"].to(where).to(dtype)
    with torch.no_grad():
        outs = det.bbox_head(det.extract_feat(img))
    heads = [made[id(t)] for t in torch.utils._pytree.tree_leaves(outs) if id(t) in made]
    bns = [m for m in det.modules() if isinstance(m, BatchNorm)]
    return out, order, bns, heads


def main(name="yolox"):
    ref, order, bns, heads = leaf_outputs(name, "cpu", torch.float32)
    cpu = leaf_outputs(name, "cpu", torch.bfloat16)[0]
    card = leaf_outputs(name, "cuda", torch.bfloat16)[0]
    widths = sorted({b.weight.numel() for b in bns})
    print(f"{name}: {len(bns)} live BNs of {widths[0] if widths else 0} to "
          f"{widths[-1] if widths else 0} channels; per leaf module, its bfloat16 output's "
          f"largest distance from float32 over float32's largest (CPU, card)")
    errs = {}
    for leaf in order:
        top = max(float(ref[leaf].abs().max()), 1e-30)
        errs[leaf] = [float((o[leaf] - ref[leaf]).abs().max()) / top for o in (cpu, card)]
        print(f"  {leaf:56s} {errs[leaf][0]:.3e} {errs[leaf][1]:.3e}")
    last = [errs[leaf] for leaf in heads]
    print(f"{name}: the largest over the leaves: CPU {max(e[0] for e in errs.values()):.3e}, "
          f"card {max(e[1] for e in errs.values()):.3e}; the head's {len(last)} outputs: CPU "
          f"{min(e[0] for e in last):.3e}-{max(e[0] for e in last):.3e}, card "
          f"{min(e[1] for e in last):.3e}-{max(e[1] for e in last):.3e}; the card's farther at "
          f"{sum(e[1] > e[0] for e in errs.values())} of {len(errs)} leaves "
          f"({torch.cuda.get_device_name(0)})")


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("torch_bf16_drift: needs a card")
    main(*sys.argv[1:])
