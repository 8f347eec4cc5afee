"""A cell cut to a tiny size for CPU runs of the harness: the sizes of the
configuration and of the mix are replaced in the loaded cell, never in the
files."""

from harness import spec


def tiny_cell(name: str, film: int = 16, photons: int = 512,
              iterations: int = 2, block: int = 8):
    cell = spec.load_cell(name)
    cell.config = dict(cell.config, width=film, height=film,
                       photonsperiteration=photons)
    cell.traffic = dict(cell.traffic, iterations_per_job=iterations)
    cell.params = dict(cell.params,
                       check=dict(cell.params["check"], block=block))
    return cell
