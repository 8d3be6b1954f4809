"""The plain reference: Algorithm 1 in plain PyTorch and NumPy, written
from the paper and the configurations, importing nothing of the program
(``repro_torch``) and taking nothing it made but the outputs it judges."""
