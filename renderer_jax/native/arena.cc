// Host staging-arena allocator with live statistics.
//
// The reference's only native component is the C++ VulkanMemoryAllocator
// wrapper (vma/: vmaCreateBuffer/vmaMapMemory/vmaCalculateStats feeding
// the imgui HUD). The XLA runtime owns the device heaps, so there are none
// to manage here, but the host-side staging story is the same: scene
// streaming wants large, long-lived, contiguously reused pinned buffers rather than
// malloc churn, plus the allocator statistics the HUD surfaces.
//
// Design: one contiguous arena per pool; best-fit free list keyed by size
// with offset-ordered coalescing on free (the same policy family VMA's
// default block allocator uses); O(log n) alloc/free; thread-safe; full
// stats (used/free/peak/fragmentation).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>

namespace {

struct Arena {
  uint8_t* base = nullptr;
  uint64_t capacity = 0;
  // free_by_offset: offset -> size (for coalescing)
  std::map<uint64_t, uint64_t> free_by_offset;
  // free_by_size: (size, offset) set emulated with multimap (best-fit)
  std::multimap<uint64_t, uint64_t> free_by_size;
  // live allocations: offset -> size
  std::map<uint64_t, uint64_t> allocs;
  uint64_t used = 0;
  uint64_t peak = 0;
  uint64_t total_allocs = 0;
  uint64_t failed_allocs = 0;
  std::mutex mu;

  void insert_free(uint64_t off, uint64_t size) {
    free_by_offset[off] = size;
    free_by_size.emplace(size, off);
  }

  void erase_free(uint64_t off, uint64_t size) {
    free_by_offset.erase(off);
    auto range = free_by_size.equal_range(size);
    for (auto it = range.first; it != range.second; ++it) {
      if (it->second == off) {
        free_by_size.erase(it);
        break;
      }
    }
  }
};

uint64_t align_up(uint64_t x, uint64_t a) { return (x + a - 1) / a * a; }

}  // namespace

extern "C" {

struct RtpuArenaStats {
  uint64_t capacity;
  uint64_t used;
  uint64_t free_bytes;
  uint64_t peak_used;
  uint64_t live_allocs;
  uint64_t total_allocs;
  uint64_t failed_allocs;
  uint64_t largest_free_block;
  uint64_t free_block_count;
};

void* rtpu_arena_create(uint64_t capacity) {
  auto* a = new (std::nothrow) Arena();
  if (!a) return nullptr;
  // 64-byte alignment for the base: cache-line/DMA friendly
  a->base = static_cast<uint8_t*>(std::aligned_alloc(64, align_up(capacity, 64)));
  if (!a->base) {
    delete a;
    return nullptr;
  }
  a->capacity = capacity;
  a->insert_free(0, capacity);
  return a;
}

void rtpu_arena_destroy(void* handle) {
  auto* a = static_cast<Arena*>(handle);
  if (!a) return;
  std::free(a->base);
  delete a;
}

void* rtpu_arena_alloc(void* handle, uint64_t size, uint64_t align) {
  auto* a = static_cast<Arena*>(handle);
  if (!a || size == 0) return nullptr;
  if (align == 0) align = 64;
  std::lock_guard<std::mutex> lock(a->mu);

  // best-fit: smallest free block that can hold size after alignment
  for (auto it = a->free_by_size.lower_bound(size); it != a->free_by_size.end();
       ++it) {
    uint64_t block_size = it->first;
    uint64_t block_off = it->second;
    // align the absolute address, not the arena-relative offset
    uint64_t base_addr = reinterpret_cast<uint64_t>(a->base);
    uint64_t aligned_off = align_up(base_addr + block_off, align) - base_addr;
    uint64_t pad = aligned_off - block_off;
    if (block_size < pad + size) continue;

    a->erase_free(block_off, block_size);
    if (pad) a->insert_free(block_off, pad);
    uint64_t tail = block_size - pad - size;
    if (tail) a->insert_free(aligned_off + size, tail);

    a->allocs[aligned_off] = size;
    a->used += size;
    if (a->used > a->peak) a->peak = a->used;
    a->total_allocs++;
    return a->base + aligned_off;
  }
  a->failed_allocs++;
  return nullptr;
}

int rtpu_arena_free(void* handle, void* ptr) {
  auto* a = static_cast<Arena*>(handle);
  if (!a || !ptr) return -1;
  std::lock_guard<std::mutex> lock(a->mu);
  uint64_t off = static_cast<uint8_t*>(ptr) - a->base;
  auto it = a->allocs.find(off);
  if (it == a->allocs.end()) return -1;  // double free / foreign pointer
  uint64_t size = it->second;
  a->allocs.erase(it);
  a->used -= size;

  // coalesce with neighbors
  uint64_t new_off = off, new_size = size;
  auto next = a->free_by_offset.lower_bound(off);
  if (next != a->free_by_offset.begin()) {
    auto prev = std::prev(next);
    if (prev->first + prev->second == off) {
      new_off = prev->first;
      new_size += prev->second;
      a->erase_free(prev->first, prev->second);
    }
  }
  next = a->free_by_offset.lower_bound(off + 1);
  if (next != a->free_by_offset.end() && next->first == off + size) {
    new_size += next->second;
    a->erase_free(next->first, next->second);
  }
  a->insert_free(new_off, new_size);
  return 0;
}

void rtpu_arena_stats(void* handle, RtpuArenaStats* out) {
  auto* a = static_cast<Arena*>(handle);
  if (!a || !out) return;
  std::lock_guard<std::mutex> lock(a->mu);
  out->capacity = a->capacity;
  out->used = a->used;
  uint64_t free_total = 0, largest = 0;
  for (auto& kv : a->free_by_offset) {
    free_total += kv.second;
    if (kv.second > largest) largest = kv.second;
  }
  out->free_bytes = free_total;
  out->peak_used = a->peak;
  out->live_allocs = a->allocs.size();
  out->total_allocs = a->total_allocs;
  out->failed_allocs = a->failed_allocs;
  out->largest_free_block = largest;
  out->free_block_count = a->free_by_offset.size();
}

}  // extern "C"
