"""The plain PyTorch reference the output check holds the program against; imports nothing of the program."""
