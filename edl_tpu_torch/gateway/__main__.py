"""``python -m edl_tpu_torch.gateway``: the gateway front door's CLI."""

from edl_tpu_torch.gateway.gateway import main

if __name__ == "__main__":
    main()
