// K5's float64 entry points: sigma_cap.cu compiled for double, a
// translation unit of its own so that nvcc builds both types at once.
#define SIGMA_CAP_F64
#include "sigma_cap.cu"
