from . import bending, collision, distance, integrate
