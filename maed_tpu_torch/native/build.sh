#!/bin/sh
# Build the native clip-ops library:  sh build.sh OUTPUT.so
#
# The JPEG decoder is required: libjpeg where its header and library are
# installed, otherwise nvJPEG from the CUDA toolkit (CUDA_HOME, default
# /usr/local/cuda), decoding on the card with host output. With neither the
# build fails and says what is missing. The output lands through an atomic
# rename, so concurrent builders never expose a partly written library.
set -e
cd "$(dirname "$0")"
OUT="$1"
[ -n "$OUT" ] || { echo "usage: sh build.sh OUTPUT.so" >&2; exit 2; }
TMP="$OUT.$$.tmp"
trap 'rm -f "$TMP"' EXIT
CUDA="${CUDA_HOME:-/usr/local/cuda}"
FLAGS="-O3 -march=native -fPIC -shared -std=c++17 -pthread"
if printf '#include <cstdio>\n#include <jpeglib.h>\nint main(){jpeg_std_error(0);}\n' \
    | g++ -x c++ - -o "$TMP" -ljpeg >/dev/null 2>&1; then
  g++ $FLAGS -DHAVE_LIBJPEG clip_ops.cc -o "$TMP" -ljpeg
  echo "libjpeg"
elif [ -f "$CUDA/include/nvjpeg.h" ] && [ -e "$CUDA/lib64/libnvjpeg.so" ]; then
  g++ $FLAGS -DHAVE_NVJPEG -I"$CUDA/include" clip_ops.cc -o "$TMP" \
      -L"$CUDA/lib64" -Wl,-rpath,"$CUDA/lib64" -lnvjpeg -lcudart
  echo "nvjpeg"
else
  echo "no JPEG decoder to build against: need libjpeg (jpeglib.h and" \
       "libjpeg.so) or nvJPEG ($CUDA/include/nvjpeg.h and" \
       "$CUDA/lib64/libnvjpeg.so)" >&2
  exit 1
fi
mv -f "$TMP" "$OUT"
