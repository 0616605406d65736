"""The reference's dry run of a few cells, in a process of its own: run as
``python tests/_torch_dryrun_ref.py '<json list of cells>'``, it prints one
JSON line of results.  ``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512
host devices before jax is imported, which is why the tests that hold the
port's dry run against it run this file as a subprocess.

Each cell is ``{"arch", "shape", "mesh": "1x1" | "16x16" | "2x16x16",
"smoke"}``; its result holds the reference's ``analyze_hlo`` dot FLOPs,
collective wire bytes (in all and by opcode) and
``memory_analysis()``'s argument and temporary bytes."""
import json
import sys
import time


def main(cells: list) -> list:
    from repro.launch import dryrun  # sets XLA_FLAGS first

    import jax

    from repro.launch.hlo_analysis import analyze_hlo
    from repro.launch.mesh import make_host_mesh, make_production_mesh

    out = []
    for cell in cells:
        t0 = time.time()
        if cell["mesh"] == "1x1":
            mesh = make_host_mesh()
        else:
            mesh = make_production_mesh(multi_pod=cell["mesh"] == "2x16x16")
        _, compiled, _ = dryrun.lower_cell(cell["arch"], cell["shape"], mesh,
                                           smoke_scale=cell.get("smoke"))
        mem = compiled.memory_analysis()
        cost = analyze_hlo(compiled.as_text(), mesh.size)
        out.append({**cell, "dot_flops": cost.dot_flops,
                    "argument_size_in_bytes": int(mem.argument_size_in_bytes),
                    "temp_size_in_bytes": int(mem.temp_size_in_bytes),
                    "collective_bytes": cost.collective_bytes,
                    "collectives": dict(cost.collectives),
                    "seconds": round(time.time() - t0, 1),
                    "jax": jax.__version__})
    return out


if __name__ == "__main__":
    print(json.dumps(main(json.loads(sys.argv[1]))))
