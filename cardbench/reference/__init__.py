"""The plain reference of the benchmark's configurations: plain PyTorch
bodies that compute each final disparity map from the input pair alone.

It imports nothing of the measured package and takes nothing the program
has made; ``cardbench.check`` runs the module a configuration names on the pairs the window served and
compares the maps the window delivered with it.
"""
