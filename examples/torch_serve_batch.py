"""Continuous-batching session-server example on the PyTorch port: a bursty
multi-tenant mix over shared lanes, with a deadline and an overload burst
that sheds (the port of `examples/serve_batch.py`, the same flags).

    PYTHONPATH=src python examples/torch_serve_batch.py            # the card
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu
"""
import argparse

from repro_torch.launch.serve import main as serve_main

HEADER = "session server: a bursty multi-tenant mix"
FLAGS = ["--ticks", "16", "--lanes", "4", "--chunk", "8",
         "--queue-capacity", "8", "--arrival-rate", "1.5",
         "--burst-at", "4", "--burst-size", "10", "--deadline", "12"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    dev = p.parse_args(argv).device
    print(f"== {HEADER} ==")
    return serve_main(FLAGS + ([] if dev is None else ["--device", dev]))


if __name__ == "__main__":
    main()
