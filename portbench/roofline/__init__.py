"""Operation and byte counts of the work each kernel and each model is
asked for, from shapes alone, whatever the kernel's schedule."""
