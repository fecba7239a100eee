"""BxDF kind bitflags and slot type ids (ref: src/bxdf/mod.rs:119-132)."""

REFLECTION = 0x01
TRANSMISSION = 0x02
DIFFUSE = 0x04
GLOSSY = 0x08
SPECULAR = 0x10
ALL = REFLECTION | TRANSMISSION | DIFFUSE | GLOSSY | SPECULAR
ALL_NON_SPECULAR = ALL & ~SPECULAR

# slot type ids for the slot-table BSDF
T_NONE = 0
T_LAMBERT_R = 1       # ref: bxdf/lambertian.rs LambertianRBxdf
T_LAMBERT_T = 2       # ref: bxdf/lambertian.rs LambertianTBxdf
T_OREN_NAYAR = 3      # ref: bxdf/oren_nayar.rs
T_FRESNEL_SPEC = 4    # ref: bxdf/fresnel.rs FresnelBxdf (specular R+T)
T_TS_R = 5            # ref: bxdf/microfacet.rs TorranceSparrowRBxdf
T_TS_T = 6            # ref: bxdf/microfacet.rs TorranceSparrowTBxdf
T_ASHIKHMIN = 7       # ref: bxdf/microfacet.rs AshikhminShirleyBxdf
T_SPECULAR_R = 8      # ref: bxdf/specular.rs SpecularRBxdf (dielectric)
T_SPECULAR_T = 9      # ref: bxdf/specular.rs SpecularTBxdf

# distribution ids
D_BECKMANN = 0
D_TROWBRIDGE = 1

KIND_OF_TYPE = {
    T_NONE: 0,
    T_LAMBERT_R: REFLECTION | DIFFUSE,
    T_LAMBERT_T: TRANSMISSION | DIFFUSE,
    T_OREN_NAYAR: REFLECTION | DIFFUSE,
    T_FRESNEL_SPEC: REFLECTION | TRANSMISSION | SPECULAR,
    T_TS_R: REFLECTION | GLOSSY,
    T_TS_T: TRANSMISSION | GLOSSY,
    T_ASHIKHMIN: REFLECTION | GLOSSY,
    T_SPECULAR_R: REFLECTION | SPECULAR,
    T_SPECULAR_T: TRANSMISSION | SPECULAR,
}
