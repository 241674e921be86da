"""``python -m repro_torch.dist --record OUT.json [--grid 2x4] [--device
cpu|cuda]``: see :mod:`repro_torch.dist.record`."""

from repro_torch.dist.record import main

if __name__ == "__main__":
    main()
