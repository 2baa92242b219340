"""Serve a small LM on the PyTorch port with batched requests (prefill,
then a decode loop): the same prefill / decode steps the port's dry run
counts for the production mesh, here on a smoke config.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch qwen2_7b
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""
import sys

from repro_torch.launch import serve


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--arch" not in argv:
        argv = ["--arch", "qwen2_7b"] + argv
    defaults = {"--batch": "8", "--prompt-len": "48", "--gen": "24",
                "--temperature": "0.8"}
    for flag, value in defaults.items():
        if flag not in argv:
            argv += [flag, value]
    return serve.main(argv + ["--smoke"])


if __name__ == "__main__":
    main()
