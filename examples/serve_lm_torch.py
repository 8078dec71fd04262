"""Batched serving through the PyTorch port: prefill a batch of prompts, then
decode with the caches updated in place. Shows the O(1)-state decode of the
SSM family (mamba2-780m), the KV-cache decode of the attention family
(granite-3-8b), both side by side in the hybrid (hymba-1.5b), the encoder's
cross K/V computed once for an enc-dec (seamless-m4t-medium), the image
patches' cross K/V of a VLM (llama-3.2-vision-90b) and the top-k experts of
the MoE family (arctic-480b with its parallel dense MLP, kimi-k2-1t with its
dense first layer and shared expert), each at its reduced widths with random
weights and stub frontend inputs.

  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

Without ``--device`` it runs on the CUDA device (and raises when there is
none), as the port's entry points do.
"""

import argparse

from repro_torch.launch import serve_decode


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    extra = ["--device", args.device] if args.device else []
    for arch in ["mamba2-780m", "granite-3-8b", "hymba-1.5b", "seamless-m4t-medium",
                 "llama-3.2-vision-90b", "arctic-480b", "kimi-k2-1t-a32b"]:
        print(f"=== {arch} (reduced) ===")
        serve_decode.main(["--arch", arch, "--batch", "4", "--prompt-len", "24",
                           "--tokens", "16"] + extra)


if __name__ == "__main__":
    main()
