from . import forces
