"""Plain PyTorch references of what the cells run, in float32 with TF32
off.  They import nothing of ``emotts_torch``, ``emotts`` or JAX, and
take from the benchmark only the inputs it made (weights by the port's
parameter names, sentences, batches, seeds); whatever the port derives
from those they work out again."""
