"""Faults planted underneath the timed path, for the tests that see the
comparison fail them and for ``readings.py --fault`` on the chip. A
serving fault wraps the loaded artifact, a training fault the train step.
"""

import math

import torch

from benchmark.harness.common import as_served, reference_maps


class Control:
    """The reference in fp8, decoded, in the program's place."""

    def __init__(self, c):
        self.c = c

    def __call__(self, serve):
        cfg = self.c.cfg
        weights = serve.model.state_dict()

        def fn(images, K, Rt):
            batch = {"images": images.numpy(), "K": K.numpy(), "Rt": Rt.numpy()}
            return as_served(cfg, reference_maps(self.c.reference, cfg, weights, batch, "cpu", "fp8"))

        return fn


def altered(serve):
    def fn(images, K, Rt):
        out = serve(images, K, Rt)
        boxes = out["boxes"].clone()
        boxes[..., 0] += 0.5 * out["valid"].float()  # every centre half a metre off
        return {**out, "boxes": boxes}

    return fn


def half_batch(serve):
    def fn(images, K, Rt):
        h = images.shape[0] // 2
        out = serve(images[:h].repeat(2, 1, 1, 1, 1), K, Rt)  # the second half never computed
        return out

    return fn


def heatmap_as(value: float):
    """The program's heatmap ``value`` everywhere and its detections
    dropped, as its decode answers such a map: a heatmap that comes out all
    low (0) or not a number (NaN)."""

    def wrap(serve):
        def fn(images, K, Rt):
            out = serve(images, K, Rt)
            return {**out, "heatmap": torch.full_like(out["heatmap"], value), "boxes": torch.zeros_like(out["boxes"]),
                    "scores": torch.zeros_like(out["scores"]), "valid": torch.zeros_like(out["valid"])}

        return fn

    return wrap


def unchanged(step):
    def fn(state, batch):
        params = {k: p.detach().clone() for k, p in state.model.named_parameters()}
        acc = {k: v.clone() for k, v in state.opt_state.acc.items()}
        m = step(state, batch)
        with torch.no_grad():
            for k, p in state.model.named_parameters():
                p.copy_(params[k])
            for k, v in state.opt_state.acc.items():
                v.copy_(acc[k])
        return m

    return fn


def train_half_batch(step):
    def fn(state, batch):
        h = len(batch["images"]) // 2
        return step(state, {k: v[:h] for k, v in batch.items()})

    return fn


def gradient_altered(step):
    def fn(state, batch):
        inner = state.tx.update
        state.tx.update = lambda s, model, grads: inner(s, model, {k: 1.25 * g for k, g in grads.items()})
        try:
            return step(state, batch)
        finally:
            state.tx.update = inner

    return fn


SERVING = {"altered": altered, "half_batch": half_batch, "blank": heatmap_as(0.0), "not_a_number": heatmap_as(math.nan)}
TRAINING = {"unchanged": unchanged, "half_batch": train_half_batch, "gradient_altered": gradient_altered}
