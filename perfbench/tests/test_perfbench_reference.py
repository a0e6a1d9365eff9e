"""The plain references against the program in float32 on the CPU, on the
same seeded weights: the same model, so that on the card the gaps measure
precision and nothing else. The references import nothing of the program;
these tests import both."""
from __future__ import annotations

import torch

from perfbench import weights
from perfbench.drivers import lm_common
from perfbench.reference import gpt2, train, vit
from perfbench.tests import tiny

CPU = torch.device("cpu")


def _lm(seed=3, name="gpt2-medium.decode"):
    cell = tiny.cell(name)
    w = lm_common.seeded(cell, seed, CPU, torch.float32)
    model = lm_common.build_model(cell, seed, CPU, dtype=torch.float32)
    return cell, w, model.eval()


def test_gpt2_reference_is_the_program_model_in_float32():
    cell, w, model = _lm()
    tokens = torch.randint(0, cell.config["vocab_size"], (2, 40),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(tokens)
    ref = gpt2.forward(w, cell.config, tokens)
    assert torch.allclose(got, ref, atol=2e-5, rtol=1e-5)


def test_gpt2_decode_through_its_cache_follows_the_full_forward():
    cell, w, _ = _lm(4)
    prompt = [5, 17, 3, 60, 2, 9]
    out = gpt2.greedy(w, cell.config, prompt, 8)
    seq = list(prompt)
    for _ in range(8):
        logits = gpt2.forward(w, cell.config, torch.tensor([seq]))
        seq.append(int(logits[0, -1].argmax()))
    assert out == seq[len(prompt):]


def test_vit_reference_is_the_program_model_in_float32():
    from idunno_tpu_torch.models.vit import ViT
    from idunno_tpu_torch.ops.preprocess import preprocess_batch

    cell = tiny.cell("vit-s16.bulk")
    c = cell.config
    w = weights.make(weights.vit_shapes(c), 7, CPU, torch.float32)
    model = ViT(num_classes=c["num_classes"], patch=c["patch_size"],
                dim=c["embed_dim"], depth=c["depth"], num_heads=c["num_heads"],
                image_size=c["img_size"])
    model.load_state_dict(w)
    images = torch.randint(0, 256, (3, 36, 36, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = model(preprocess_batch(images, crop=32).permute(0, 3, 1, 2))
    ref = vit.logits(w, c, images)
    assert torch.allclose(got, ref, atol=2e-5, rtol=1e-5)


def test_train_reference_is_the_program_step_in_float32():
    from idunno_tpu_torch.engine.train import TrainState, adamw, flat_tx
    from idunno_tpu_torch.engine.train_lm import make_lm_train_step

    cell, w, model = _lm(5, "gpt2-medium.train")
    opt_cfg = cell.traffic["optimizer"]
    model.train()
    b1, b2 = opt_cfg["betas"]
    opt = flat_tx(adamw(opt_cfg["lr"], b1=b1, b2=b2, eps=opt_cfg["eps"],
                        weight_decay=opt_cfg["weight_decay"]))(
        model.parameters())
    step = make_lm_train_step(model, opt)
    state = TrainState(step=0, model=model, optimizer=opt)
    tokens = torch.randint(0, cell.config["vocab_size"], (4, 16),
                           generator=torch.Generator().manual_seed(3))
    ref_state: dict = {}
    for _ in range(2):
        got = float(step(state, tokens)["loss"])
        loss, grads = train.loss_and_grads(w, cell.config, tokens, rows=2)
        train.adamw(w, grads, ref_state, lr=opt_cfg["lr"],
                    betas=(b1, b2), eps=opt_cfg["eps"],
                    weight_decay=opt_cfg["weight_decay"])
        assert abs(got - loss) < 1e-5 * loss
    # Adam turns round-off in a near-zero gradient into a step of up to lr
    # either way; the rest of each weight agrees to round-off
    for name, p in model.named_parameters():
        diff = (p.detach() - w[name]).abs()
        assert float(diff.max()) <= 4 * opt_cfg["lr"], name
        assert float((diff > 1e-6).float().mean()) < 0.01, name
