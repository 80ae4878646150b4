import sys
from pathlib import Path

# the program under test (src/repro_torch) for the CPU tests of the harness
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
