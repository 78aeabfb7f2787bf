"""Subprocess experiment entry point (port of
``nlbac_tpu/utils/run_entrypoint.py``): the payload is the pickled
``(NLBACConfig, train kwargs)`` of the port, zlib-compressed and
base64-encoded, for cluster wrappers that launch one variant per process:

    payload = encode_experiment(cfg, output_dir="runs/x")
    subprocess.run([sys.executable, "-m",
                    "nlbac_tpu_torch.utils.run_entrypoint", payload])

The child trains through the port's ``train`` on the GPU unless the
kwargs hold ``device="cpu"``. Decode only trusted payloads: they are
pickles.
"""

from __future__ import annotations

import base64
import pickle
import sys
import zlib


def encode_experiment(cfg, **train_kwargs) -> str:
    blob = pickle.dumps((cfg, train_kwargs),
                        protocol=pickle.HIGHEST_PROTOCOL)
    return base64.b64encode(zlib.compress(blob)).decode("ascii")


def decode_experiment(payload: str):
    cfg, train_kwargs = pickle.loads(
        zlib.decompress(base64.b64decode(payload.encode("ascii"))))
    return cfg, train_kwargs


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        raise SystemExit("usage: python -m "
                         "nlbac_tpu_torch.utils.run_entrypoint "
                         "<base64 payload>")
    cfg, train_kwargs = decode_experiment(argv[0])
    from nlbac_tpu_torch.train.cli import train
    train(cfg, **train_kwargs)


if __name__ == "__main__":
    main()
