"""The dry-run's fake world in its own process (its fake process group
would stay in a pytest worker): ``python tests/_dryrun_fake.py CELLS.json
OUT.json``.

CELLS is a list of [arch, shape name, kind, seq_len, global_batch, mesh
kind]; each runs ``repro_torch.launch.dryrun.run_cell`` on the smoke model
at that reduced shape on the fake world of that mesh kind ("2x2", ...), and
OUT gets the records in order."""

import json
import sys

from repro_torch import configs
from repro_torch.launch import dryrun


def main(src: str, dst: str) -> None:
    with open(src) as f:
        cells = json.load(f)
    out = []
    for arch, name, kind, seq, batch, mesh in cells:
        case = configs.ShapeCase(name, kind, seq, batch)
        out.append(dryrun.run_cell(arch, name, mesh, shape=case, smoke=True))
    with open(dst, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
