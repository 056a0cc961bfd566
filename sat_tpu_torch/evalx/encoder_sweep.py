"""Encoder throughput sweep, ported from ``sat_tpu/evalx/encoder_sweep.py``
(reference: dev/dev_encoder.py:77-104 + dev/encoder_summaries.txt): per-arch
latency, images per second, parameter count and annotation shape, printed in
the reference's line format.

    python -m sat_tpu_torch.evalx.encoder_sweep [--archs A ...] [--batch 32]
        [--input_size 224] [--encoder_size N] [--encoder_dim N]
        [--precision 16|32]

Each arch's encoder is built with flax's initialisers from seed 0.  The time
per batch is the JAX package's chained marginal: k forward passes, each
input moved by the running sum of the outputs so far (the passes form one
chain the device cannot reorder or skip), the end found by reading that sum
to the host, and the difference between k = 10 and k = 2 over 8: the fixed
cost of a call and its read-back drops out.  Runs on the card unless
``device="cpu"``."""

from __future__ import annotations

import argparse
import time
from typing import List, Optional


def count_params(module) -> int:
    """The module's parameters, not its running statistics (JAX counts
    ``variables["params"]``)."""
    return int(sum(p.numel() for p in module.parameters()))


def sweep(archs: List[str], batch: int = 32, input_size: int = 224,
          encoder_size: Optional[int] = None, encoder_dim: Optional[int] = None,
          precision: int = 16, k_small: int = 2, k_large: int = 10, device=None):
    import numpy as np
    import torch

    from ..config import SATConfig
    from ..models.backbones import flax_init_
    from ..models.encoder import encoder_from_config, probe_encoder
    from ..utils.platform import resolve_device

    dev = resolve_device(device)
    rows = []
    for arch in archs:
        cfg = SATConfig(encoder_arch=arch, input_size=input_size,
                        encoder_size=encoder_size, encoder_dim=encoder_dim)
        features, (h, w) = probe_encoder(cfg)
        attention = h * w
        cfg = cfg.replace(encoder_dim=features)
        enc = flax_init_(encoder_from_config(cfg).to(dev),
                         torch.Generator(dev).manual_seed(0)).eval()
        params_m = count_params(enc) * 1e-6
        dt_in = torch.bfloat16 if precision == 16 else torch.float32
        if precision == 16:
            enc = enc.to(torch.bfloat16)   # every float32 parameter and buffer
        data = torch.from_numpy(np.random.default_rng(0).random(
            (batch, input_size, input_size, 3), np.float32)).to(dev, dt_in)

        @torch.no_grad()
        def loop(k):
            im, acc = data, torch.zeros((), dtype=torch.float32, device=dev)
            for _ in range(k):
                acc = acc + enc(im).sum().float()
                im = im + (acc % 3).to(im.dtype) * 1e-4
            return acc

        times = {}
        for k in (k_small, k_large):
            float(loop(k))
            t0 = time.time()
            float(loop(k))
            times[k] = time.time() - t0
        dt = (times[k_large] - times[k_small]) / (k_large - k_small)
        latency = dt * 1e3
        row = dict(arch=arch, features=features, attention=attention,
                   params=params_m, latency_ms=latency, batch=batch,
                   batches_per_sec=1 / dt, imgs_per_sec=batch / dt)
        rows.append(row)
        print(f"arch={arch:18} features={features:4d} attention={attention:3d} "
              f"params={params_m:6.2f}M. bf16={precision==16!s:5} "
              f"Latency={latency:7.3f} ms. batch={batch:4d}. "
              f"Batches/s={1/dt:5.1f}. Imgs/s={batch/dt:7.1f}.", flush=True)
        del enc, data
    return rows


def main(argv=None, device=None):
    p = argparse.ArgumentParser(description="encoder throughput sweep")
    p.add_argument("--archs", nargs="+", default=[
        "shufflenet_v2_x0_5", "mobilenet_v3_small", "squeezenet1_1",
        "resnet18", "resnet50"])
    p.add_argument("--batch", default=32, type=int)
    p.add_argument("--input_size", default=224, type=int)
    p.add_argument("--encoder_size", default=None, type=int)
    p.add_argument("--encoder_dim", default=None, type=int)
    p.add_argument("--precision", default=16, type=int, choices=[16, 32])
    a = p.parse_args(argv)
    return sweep(a.archs, a.batch, a.input_size, a.encoder_size, a.encoder_dim,
                 a.precision, device=device)


if __name__ == "__main__":
    main()
