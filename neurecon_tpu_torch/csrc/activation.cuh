// The hidden layers' activation of the surface MLP, shared by every kernel
// on surface_mma.cuh. It is a launch argument (the wrappers pass the
// surface's, ops/fused_nablas.py `activation_code`) that picks one of each
// kernel's two instantiations: a template parameter, so that no epilogue
// carries a branch. Softplus(beta = 100), or the SIREN sine
// sin(W0 a), whose derivatives are W0 cos(W0 a) and -W0^2 sin(W0 a). A sine
// net has no skips (the pack and the wrappers refuse them).
#pragma once

namespace ntt {

constexpr int ACT_SOFTPLUS = 0;
constexpr int ACT_SINE = 1;
constexpr float SIREN_W0 = 30.f;

}  // namespace ntt
