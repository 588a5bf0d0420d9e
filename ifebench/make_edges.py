"""Write the bin edges of a bag configuration: for each (scale, feature),
the equal-frequency edges (the i/bins quantiles, i = 1 .. bins - 1) of the
float64 reference's feature over the masked voxels of one seed scan (pool
slot 0 of seed 0, lung mask) at the configuration's size and spacing.

    python3 -m ifebench.make_edges [--config mil-bag-4s] [--device cuda]

The edges are data of the configuration (configs/<edges file>); they were
made once on the card with this script and are committed.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ifebench import inputs, reference

PACKAGE = Path(__file__).resolve().parent
SEED = 0


def quantile_edges(values: torch.Tensor, bins: int):
    """The i/bins quantiles of `values`, i = 1 .. bins - 1, by linear
    interpolation between order statistics (numpy's default)."""
    v = torch.sort(values.to(torch.float64)).values
    q = torch.arange(1, bins, dtype=torch.float64, device=v.device) / bins
    pos = q * (v.numel() - 1)
    lo = pos.floor().long()
    hi = torch.clamp(lo + 1, max=v.numel() - 1)
    frac = pos - lo.to(torch.float64)
    return (v[lo] + (v[hi] - v[lo]) * frac).tolist()


def make_edges(config: dict, device):
    scan = config["scan"]
    image, mask = inputs.make_scan(scan, "lung", SEED, 0, 1, device)
    inside = mask != 0
    edges = []
    for sigma in config["sigmas"]:
        feats = reference.features_region(image, mask, sigma, scan["spacing"],
                                          config["truncate"])
        for k in range(reference.N_FEATURES):
            edges.append(quantile_edges(feats[k][inside],
                                        config["bag"]["bins"]))
        del feats
    return {"made_by": "python3 -m ifebench.make_edges", "seed": SEED,
            "slot": 0, "mask": "lung", "shape": list(image.shape),
            "sigmas": config["sigmas"], "bins": config["bag"]["bins"],
            "order": "scale-major: row i * 8 + k is scale i, feature k",
            "edges": edges}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m ifebench.make_edges")
    p.add_argument("--config", default="mil-bag-4s")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    config = json.loads((PACKAGE / "configs" / f"{args.config}.json").read_text())
    data = make_edges(config, torch.device(args.device))
    out = PACKAGE / "configs" / config["bag"]["edges"]
    out.write_text(json.dumps(data, indent=1) + "\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
