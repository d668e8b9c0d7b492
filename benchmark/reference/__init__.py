"""The plain reference the benchmark judges the program's outputs by.

Plain PyTorch and NumPy. It imports nothing of the program under test and
takes nothing the program made: it builds its own scene tables and BVH
from a configuration's description and renders with them.
"""
