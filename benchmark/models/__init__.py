"""One module per architecture a configuration file names: how the program is built from it, and its reference."""
