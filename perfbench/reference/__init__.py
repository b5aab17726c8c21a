"""The plain reference: plain PyTorch and numpy, importing nothing of the
program, that works out each checked answer again from the inputs."""
