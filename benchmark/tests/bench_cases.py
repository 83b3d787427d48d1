"""Small traffic for the CPU tests: each cell's own traffic file with a
pool of two short streams."""

from harness import manifest


def traffic(workload: str, pool: int = 2) -> dict:
    bench = manifest.load()
    tr = dict(manifest.traffic(manifest.cell(bench, workload)["traffic"]))
    tr["pool"] = pool
    tr["lengths_s"] = dict(tr["lengths_s"], lo=1.5, hi=3.5)
    return tr


CELLS = [w["name"] for w in manifest.load()["workloads"]]
