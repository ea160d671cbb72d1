"""The dry-run on the card at smoke width: ``python tests/_dryrun_card.py
OUT.json``.  The smoke qwen1.5's train and decode cells at reduced shapes
through ``repro_torch.launch.dryrun.run_cell``, first on a fake world of
one, then on a real NCCL world of one on this process's card; OUT gets
{kind: {"fake": record, "real": record}}."""

import json
import sys

import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib

CELLS = {"train": ("train_4k", 32, 8), "decode": ("decode_32k", 64, 4)}


def main(dst: str) -> None:
    cases = {kind: configs.ShapeCase(name, kind, seq, batch)
             for kind, (name, seq, batch) in CELLS.items()}
    out = {kind: {"fake": dryrun.run_cell("qwen1.5-0.5b", c.name, "1x1", shape=c, smoke=True)}
           for kind, c in cases.items()}
    mesh_lib.init_process_group("cuda")
    try:
        mesh = mesh_lib.make_host_mesh(1, device_type="cuda")
        for kind, c in cases.items():
            out[kind]["real"] = dryrun.run_cell("qwen1.5-0.5b", c.name, "1x1", mesh=mesh,
                                                shape=c, smoke=True)
    finally:
        dist.destroy_process_group()
    with open(dst, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
