"""The renderer's constants, as the upstream SPCBPT settles them
(ssufujia/SPCBPT-OptiX7, optixPathTracer.h:31-39): a frozen copy for the
plain reference, which imports nothing of the program."""
NUM_SUBSPACE = 1000
NUM_SUBSPACE_LIGHTSOURCE = int(0.2 * NUM_SUBSPACE)
NUM_LIGHT_TREE_SUBSPACE = NUM_SUBSPACE - NUM_SUBSPACE_LIGHTSOURCE
MIN_RR_RATE = 0.3
CONSERVATIVE_RATE = 0.2
CONNECTION_N = 3
PT_MAX_DEPTH = 30
SUBPATH_MAX_DEPTH = 50
# every transport ray is two-sided, as in the program
CULL_BACKFACE = False
SCENE_EPSILON = 1e-3
