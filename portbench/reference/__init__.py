"""The benchmark's plain references, written again from the rules they
follow: plain NumPy and PyTorch, importing nothing of the program under test.
"""
