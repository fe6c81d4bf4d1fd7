"""The benchmark of ``lpopc_tpu_torch`` (see README.md). Importing it loads
nothing of the program."""
