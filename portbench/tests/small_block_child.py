"""child.py with the port's FASTQ reader taking 64 KiB blocks, so that a
CPU run's warm-up needs a few hundred reads, not 8 MiB of them. For the
benchmark's CPU tests only; its runs use child.py."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BLOCK = 64 << 10

if __name__ == "__main__":
    from bwamem_tpu_torch.io import fastx

    fastx._read_fastx_native.__defaults__ = (BLOCK,)
    import child

    sys.exit(child.main())
