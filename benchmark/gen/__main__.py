"""Write one input file of the benchmark in a process of its own:

    python -m benchmark.gen <generator> <path> <seed> '<params as JSON>'

runs `gen/<generator>.py`'s `write(path, seed=seed, **params)` and prints
the bytes written.
"""

import importlib
import json
import sys


def main(argv) -> int:
    name, path, seed, params = argv
    gen = importlib.import_module(f"{__package__}.{name}")
    print(gen.write(path, seed=int(seed), **json.loads(params)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
