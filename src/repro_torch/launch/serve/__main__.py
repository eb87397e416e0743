# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""``python -m repro_torch.launch.serve``: the standalone generation bench."""
from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
