// The watermarks' running max and min, shared by the four kernels.
//
// They fold as torch.maximum / torch.minimum fold them in the plain
// versions (and jnp.maximum / jnp.minimum in the reference): NaN when
// either operand is NaN.  fmaxf and fminf drop a NaN operand, so a
// diverged draw's beta_abs_max, nu_min and nu_max would differ.  PTX's
// .NaN modifier (sm_80 on) does the NaN-keeping fold in fmaxf's one
// instruction; on finite operands it gives fmaxf's / fminf's bits.

#pragma once

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
