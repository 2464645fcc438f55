"""Physical and indexing constants of the FV3 model (copied from pace_tpu).

Physical constant values follow the GFS-physics constant set used by the
reference implementation (ai2cm/pace, util/pace/util/constants.py:33-97);
these are physical data, shared with the Fortran FV3GFS model.
"""

# ---------------------------------------------------------------------------
# Dimension names (used by Quantity metadata and the partitioner)
# ---------------------------------------------------------------------------
X_DIM = "x"
X_INTERFACE_DIM = "x_interface"
Y_DIM = "y"
Y_INTERFACE_DIM = "y_interface"
Z_DIM = "z"
Z_INTERFACE_DIM = "z_interface"
TILE_DIM = "tile"
X_DIMS = (X_DIM, X_INTERFACE_DIM)
Y_DIMS = (Y_DIM, Y_INTERFACE_DIM)
Z_DIMS = (Z_DIM, Z_INTERFACE_DIM)
HORIZONTAL_DIMS = X_DIMS + Y_DIMS
INTERFACE_DIMS = (X_INTERFACE_DIM, Y_INTERFACE_DIM, Z_INTERFACE_DIM)
SPATIAL_DIMS = X_DIMS + Y_DIMS + Z_DIMS

N_HALO_DEFAULT = 3
N_TILES = 6
ROOT_RANK = 0

# Edge identifiers (tile-local, in index space: i increases east, j north)
WEST = 0
EAST = 1
NORTH = 2
SOUTH = 3
EDGES = (WEST, EAST, NORTH, SOUTH)

# ---------------------------------------------------------------------------
# Physical constants (GFS physics set)
# ---------------------------------------------------------------------------
RADIUS = 6.3712e6  # Radius of the Earth [m]
PI = 3.1415926535897931
OMEGA = 7.2921e-5  # Rotation rate of the earth [1/s]
GRAV = 9.80665  # Acceleration due to gravity [m/s^2]
RGRAV = 1.0 / GRAV
RDGAS = 287.05  # Gas constant for dry air [J/kg/K]
RVGAS = 461.50  # Gas constant for water vapor [J/kg/K]
HLV = 2.5e6  # Latent heat of evaporation [J/kg]
HLF = 3.3358e5  # Latent heat of fusion [J/kg]
CP_AIR = 1004.6  # Heat capacity of dry air at constant pressure [J/kg/K]
KAPPA = RDGAS / CP_AIR
TFREEZE = 273.15

DZ_MIN = 2.0
CV_AIR = CP_AIR - RDGAS
RDG = -RDGAS / GRAV
CNST_0P20 = 0.2
K1K = RDGAS / CV_AIR
CV_VAP = 3.0 * RVGAS
ZVIR = RVGAS / RDGAS - 1.0
C_ICE = 1972.0  # Heat capacity of ice at -15C
C_LIQ = 4.1855e3  # Heat capacity of water at 15C
CP_VAP = 4.0 * RVGAS
TICE = 273.16
DC_ICE = C_LIQ - C_ICE
DC_VAP = CP_VAP - C_LIQ
D2ICE = DC_VAP + DC_ICE
LI0 = HLF - DC_ICE * TICE
EPS = RDGAS / RVGAS
LV0 = HLV - DC_VAP * TICE
LI00 = HLF - DC_ICE * TICE
LI2 = LV0 + LI00
E00 = 611.21  # Saturation vapor pressure at 0C [Pa]
T_WFR = TICE - 40.0  # homogeneous freezing temperature
TICE0 = TICE - 0.01
T_MIN = 178.0
T_SAT_MIN = TICE - 160.0
LAT2 = (HLV + HLF) ** 2
