#!/usr/bin/env bash
# Build the native C++ marching-tetrahedra extractor into the git-ignored
# levelsetpy_tpu/_native/ (viz/_native.py also runs this on first use).
# Portable flags: the library is built on the machine that uses it.
set -euo pipefail
cd "$(dirname "$0")/.."
mkdir -p levelsetpy_tpu/_native
out=levelsetpy_tpu/_native/libmarching.so
tmp="$(mktemp levelsetpy_tpu/_native/.libmarching.XXXXXX)"
trap 'rm -f "$tmp"' EXIT
g++ -O3 -shared -fPIC -std=c++17 native/marching_tet.cpp -o "$tmp"
mv -f "$tmp" "$out"   # atomic: a concurrent build never sees a partial file
echo "built $out"
